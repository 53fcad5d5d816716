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
  * **Gateway hooks.**  ``admission_hook(engine)`` runs before every
    admission pass and ``token_sink(req, token, done)`` sees every emitted
    token; step-time EWMAs (``ewma_prefill_s_per_tok``,
    ``ewma_decode_step_s``) feed the gateway's SLO admission.
  * **Migration state.**  ``snapshot_state``/``restore_state`` move a
    quiesced tenant (requests, queue, MMU page tables, the KV of every
    live page, host-evicted payloads, the sampling seed) through
    ``repro_torch.core.migrate``'s container; bf16 KV travels as tagged
    int16 bits (``repro_torch.core.host_codec``).  The sampling seed rides
    the header so that sampled streams continue exactly across a move; a
    reference container's JAX PRNG key is ignored (greedy streams carry
    over between the two packages).

  * **Spans.**  While :mod:`repro_torch.telemetry.spans` records, each
    step records ``engine.step`` and its ``engine.admit``,
    ``engine.prefill_chunks``, ``engine.prefill_batch``, ``engine.decode``
    (attribute ``rows``), ``engine.bookkeeping`` and ``engine.wait`` (every
    point where the host blocks on the device) spans.  They reuse the clock
    readings behind ``decode_step_times``, ``prefill_s`` and the EWMAs;
    off, each costs one check.

  * **Tensor parallel.**  A ``mesh`` (a ``DeviceMesh``) whose ``model``
    dim is larger than one builds a :class:`~repro_torch.serve.tp.
    TPContext`: this rank's weight shards, pools of its KV heads, and a
    reduction through ``collectives`` after each attention and FFN block.
    Every rank runs the same engine on the same submits; host state is
    replicated.  Three rules keep the ranks from diverging: each step the
    (B,) token vector sampled on model-rank 0 is broadcast over the
    ``model`` group and every rank advances from it; the step-time samples
    behind the EWMAs are rank 0's, carried in the same broadcast; every
    collective is issued from the engine's calling thread, in program
    order.  The pager and migration gather every head over the group, so
    the host copy and the wire format are shard-agnostic (a TP tenant
    migrates to a single-device shell).  A gateway's ``admission_hook``
    (its backfill, which reads the rank's own clock) runs on model-rank 0
    alone, and the other ranks replay its outcome from one broadcast
    before ``_admit`` (:meth:`~repro_torch.serve.tp.TPContext.backfill`;
    when rank 0's backfill raises, every rank raises after the broadcast);
    any other hook runs on every rank and must decide from replicated
    state.
"""
from __future__ import annotations

import functools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import FaultKind
from repro_torch.core.port import Invocation, PortError
from repro_torch.core.host_codec import weights_from_host, weights_to_host
from repro_torch.core.services.mmu import MMU
from repro_torch.device import resolve_device
from repro_torch.serve.paged_model import (decode_step_paged,
                                           flat_page_indices,
                                           gather_kv_pages, make_pools,
                                           prefill_chunk_paged,
                                           prefill_shared_paged,
                                           scatter_kv_pages)
from repro_torch.telemetry import spans


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = disabled
    top_p: float = 1.0                # >= 1 = disabled
    tid: int = 0                      # submitting cThread
    priority: int = 0                 # scheduler priority (higher = sooner)
    deadline_s: Optional[float] = None  # absolute SLO deadline (perf_counter)
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
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(
                    "mesh must be a torch.distributed DeviceMesh with named "
                    f"dims (launch/mesh.py), not {type(mesh).__name__}")
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
        # step-time EWMAs (SLO admission feasibility inputs): seconds per
        # prefilled prompt token and per fused decode step, each sample
        # clamped against the running estimate
        self.ewma_prefill_s_per_tok: Optional[float] = None
        self.ewma_decode_step_s: Optional[float] = None
        self.prefill_obs = 0
        self.decode_obs = 0
        self._ewma_alpha = 0.25
        # gateway hooks: ``admission_hook(engine)`` runs at the top of
        # every step (before ``_admit``); ``token_sink(req, token, done)``
        # fires for every emitted token (prefill first tokens included)
        self.admission_hook = None
        self.token_sink = None
        # Tensor-parallel serving: a mesh with a model dim > 1 shards the
        # weights and KV pools over its ranks while everything host-side
        # stays replicated; ``collectives`` (without a mesh: unused, as in
        # the reference) carries the per-layer partial-sum reductions
        self.mesh = mesh
        self.tp = None
        if mesh is not None and dict(zip(
                mesh.mesh_dim_names, mesh.shape)).get("model", 1) > 1:
            from repro_torch.serve.tp import TPContext
            self.tp = TPContext(cfg, mesh, params, page_size=self.page,
                                collectives=collectives)
            self.params = self.tp.params
            self._decode_step = self.tp.decode_step
            self._prefill_shared = self.tp.prefill_shared
            self._prefill_chunk = self.tp.prefill_chunk
        else:
            self._decode_step = functools.partial(
                decode_step_paged, cfg=cfg, page_size=self.page)
            self._prefill_shared = functools.partial(
                prefill_shared_paged, cfg=cfg, page_size=self.page)
            self._prefill_chunk = functools.partial(
                prefill_chunk_paged, cfg=cfg, page_size=self.page)
        # KV pools in the model's dtype (float32 params -> float32 pools,
        # as the reference engine keeps them); under TP this rank's heads
        self.pools = make_pools(
            cfg if self.tp is None else self.tp.local_cfg,
            mmu.config.n_pages, self.page, dtype=table.dtype,
            device=self.device)
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

    # ------------------------------------------------ TP: rank agreement ----
    def _tp_agree(self, toks: torch.Tensor, t0: float):
        """Model-rank 0's ``toks`` (int32, on the device) and its seconds
        since ``t0``, on every rank of the TP group: ONE broadcast of a
        (n + 1,) int32 vector whose last entry holds the float32 bits of
        rank 0's time.  Returns (host tokens, rank 0's seconds, the device
        tokens).  Every rank then advances its host state, and its
        EWMAs, from the same values.  It blocks: an ``engine.wait`` span."""
        with spans.span("engine.wait"):
            self._sync()
            dt = np.asarray([time.perf_counter() - t0], np.float32)
            buf = torch.cat([toks.to(torch.int32).reshape(-1),
                             torch.from_numpy(dt.view(np.int32)).to(
                                 self.device)])
            self.tp.broadcast_from_rank0(buf)
            host = buf.cpu().numpy()
        return host[:-1], float(host[-1:].view(np.float32)[0]), buf[:-1]

    def gather_kv(self, flat) -> Dict[str, torch.Tensor]:
        """The pool slots ``flat`` on the device, every KV head (under TP,
        gathered over the group).  Every export of KV pages goes through
        here (pager, snapshot, pre-copy rounds), so the wire format holds
        every head whatever the source's TP degree."""
        kv = gather_kv_pages(self.pools, flat)
        if self.tp is not None:
            kv = {s: self.tp.gather_heads(v) for s, v in kv.items()}
        return kv

    def scatter_kv(self, flat, data) -> None:
        """Write full-head payloads into the pool slots ``flat`` (under TP,
        this rank's heads of them)."""
        if self.tp is not None:
            data = {s: self.tp.local_heads(v) for s, v in data.items()}
        scatter_kv_pages(self.pools, flat, data)

    # ------------------------------------------------- evict-with-copy -----
    def _pager_gather(self, ppage: int) -> Dict[str, torch.Tensor]:
        """Copy one physical page's KV (all layers, every head) to the
        host — called by the MMU just before it recycles the device
        page."""
        flat = flat_page_indices([ppage], self.cfg.n_layers,
                                 self.mmu.config.n_pages)
        kv = self.gather_kv(flat)
        return {"k": kv["k"].cpu(), "v": kv["v"].cpu()}

    def _pager_scatter(self, ppage: int, data) -> None:
        """Write a preserved page payload (tensors, or a container's
        numpy arrays with bf16 as tagged bits) into a freshly mapped
        device page (MMU fault-back-in, pre-copy staging)."""
        flat = flat_page_indices([ppage], self.cfg.n_layers,
                                 self.mmu.config.n_pages)
        self.scatter_kv(flat, weights_from_host(data))

    # -------------------------------------------------------------- API ----
    def submit(self, prompt: List[int], max_new_tokens: int = 16, *,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, tid: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
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
            priority=priority, deadline_s=deadline_s,
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

    def _ewma(self, prev: Optional[float], sample: float) -> float:
        """EWMA update with a 10x clamp against the running estimate so
        a one-off outlier (a first call's start-up) cannot poison the
        feasibility math."""
        if prev is None:
            return sample
        a = self._ewma_alpha
        return (1 - a) * prev + a * min(sample, 10.0 * prev)

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
            with spans.span("engine.prefill_chunks", t0) as sp:
                self._prefill_chunk(
                    self.params, self.pools, self._tensor(tokens, i32),
                    self._tensor(q_lens, i32), self._tensor(q_starts, i32),
                    self._tensor(tables, i32))
                with spans.span("engine.wait") as wait:
                    self._sync()
                    t1 = time.perf_counter()
                    wait.close(t1)
                sp.close(t1)
            dt = t1 - t0
            self.prefill_s += dt
            self.prefill_computed += n * chunk
            if self.tp is not None:
                # the EWMA sample is model-rank 0's
                _, dt, _ = self._tp_agree(
                    torch.zeros(0, dtype=i32, device=self.device), t0)
            self.ewma_prefill_s_per_tok = self._ewma(
                self.ewma_prefill_s_per_tok, dt / (n * chunk))
            self.prefill_obs += 1
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
        with spans.span("engine.prefill_batch", t0) as sp:
            first, now, sample, q_lens = self._prefill_forward(rows, t0)
            sp.close(now)
        self.prefill_s += now - t0
        for _, req, _, wfrom in rows:
            self.mmu.mark_dirty_range(req.rid, wfrom, len(req.prompt))
        self.ewma_prefill_s_per_tok = self._ewma(
            self.ewma_prefill_s_per_tok,
            sample / max(int(q_lens.sum()), 1))
        self.prefill_obs += 1
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
                if self.token_sink is not None:
                    self.token_sink(req, tok, True)
                continue
            if self.token_sink is not None:
                self.token_sink(req, tok, False)
            slots_i.append(i)
            # write position of the NEXT decode step's token
            srows.append((len(req.prompt), tok, req.temperature,
                          req.top_k, req.top_p, req.rid))
        if slots_i:
            self._sync_slot_state(slots_i, srows)

    def _prefill_forward(self, rows, t0: float):
        """The padded forward of :meth:`_prefill_batch` and the read-back
        of its first tokens: (the first tokens on the host, the clock
        reading after them, the EWMA sample, the rows' query lengths)."""
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
        first = self._prefill_shared(
            self.params, self.pools, self._tensor(tokens, i32),
            self._tensor(q_lens, i32), self._tensor(q_starts, i32),
            self._tensor(write_from, i32), self._tensor(tables, i32),
            self.seed, self._tensor(temps, f32), self._tensor(topks, i32),
            self._tensor(topps, f32), self._tensor(seq_ids, i32),
            filters_on=bool((topks > 0).any() or (topps < 1.0).any()))
        if self.tp is None:
            with spans.span("engine.wait") as wait:
                first = first.cpu().numpy()
                now = time.perf_counter()
                wait.close(now)
            sample = now - t0
        else:
            # every rank takes model-rank 0's first tokens and time
            first, sample, _ = self._tp_agree(first, t0)
            now = time.perf_counter()
        return first, now, sample, q_lens

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
        with spans.span("engine.step"):
            return self._step()

    def _step(self) -> int:
        if self.shell is not None:
            health = getattr(self.shell, "health", None)
            if health is not None:
                health.beat(self.slot)      # watchdog: slot is decoding
        self._settle_io()
        if self.admission_hook is not None:
            gateway = (self.tp.gateway_of(self.admission_hook)
                       if self.tp is not None else None)
            if gateway is not None:
                # clock-driven: decided on model-rank 0, replayed here
                self.tp.backfill(self, gateway)
            else:
                self.admission_hook(self)
        with spans.span("engine.admit"):
            self._admit()
        self._prefill_chunks()
        # decode runs over BOUND rows only: chunk-prefilling rows hold a
        # slot + pages but emit nothing until their final chunk lands
        live = [i for i, r in enumerate(self.slots)
                if r is not None and r.prefill_pos < 0]
        if not live:
            return 0
        t0 = time.perf_counter()
        with spans.span("engine.decode", t0, rows=len(live)) as sp:
            toks, t1, sample = self._decode(t0)
            sp.close(t1)
        dt = t1 - t0
        self.decode_step_times.append(dt)
        self.ewma_decode_step_s = self._ewma(self.ewma_decode_step_s,
                                             sample)
        self.decode_obs += 1
        self.steps += 1
        with spans.span("engine.bookkeeping", t1):
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
                if self.token_sink is not None:
                    self.token_sink(req, tok, req.done)
            if freed:
                self._sync_slot_state(freed,
                                      [(0, 0, 0.0, 0, 1.0, 0)] * len(freed))
            self.tokens_out += emitted
        return emitted

    def _decode(self, t0: float):
        """One decode step over the bound rows and the read-back of its
        tokens: (host tokens, the clock reading after them, the EWMA
        sample: model-rank 0's seconds under TP)."""
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
        next_toks, self.dev_lens = self._decode_step(
            self.params, self.pools, tables, self.dev_lens,
            self.dev_tokens, self.seed, self.dev_temps, self.dev_topk,
            self.dev_topp, self.dev_rids,
            filters_on=bool((self._topk > 0).any()
                            or (self._topp < 1.0).any()))
        if self.tp is None:
            self.dev_tokens = next_toks
            # the ONLY per-step device->host copy: the (B,) int32 tokens
            with spans.span("engine.wait") as wait:
                toks = next_toks.cpu().numpy()
                t1 = time.perf_counter()
                wait.close(t1)
            return toks, t1, t1 - t0
        # model-rank 0's tokens and step time, broadcast over the group
        toks, sample, self.dev_tokens = self._tp_agree(next_toks, t0)
        return toks, time.perf_counter(), sample

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

    # ------------------------------------------- migration state (v2) ------
    @staticmethod
    def _req_to_dict(req: Request) -> Dict:
        return {"rid": req.rid, "prompt": list(req.prompt),
                "max_new_tokens": req.max_new_tokens,
                "temperature": float(req.temperature),
                "top_k": int(req.top_k), "top_p": float(req.top_p),
                "tid": req.tid, "priority": int(req.priority),
                "deadline_s": (None if req.deadline_s is None
                               else float(req.deadline_s)),
                "out_tokens": list(req.out_tokens),
                "t_submit": float(req.t_submit),
                "t_first_token": float(req.t_first_token)}

    @staticmethod
    def _req_from_dict(d: Dict) -> Request:
        dl = d.get("deadline_s")
        return Request(rid=int(d["rid"]), prompt=list(d["prompt"]),
                       max_new_tokens=int(d["max_new_tokens"]),
                       temperature=float(d["temperature"]),
                       top_k=int(d["top_k"]), top_p=float(d["top_p"]),
                       tid=int(d["tid"]),
                       priority=int(d.get("priority", 0)),
                       deadline_s=None if dl is None else float(dl),
                       out_tokens=list(d["out_tokens"]),
                       t_submit=float(d["t_submit"]),
                       t_first_token=float(d["t_first_token"]))

    def geometry(self) -> Dict[str, int]:
        """The shape contract a migration peer must match byte-for-byte:
        page geometry and the KV head layout of the pools."""
        return {"page_size": self.page,
                "n_layers": self.cfg.n_layers,
                "n_kv_heads": self.cfg.n_kv_heads,
                "head_dim": self.cfg.resolved_head_dim,
                "vocab_size": self.cfg.vocab_size}

    def snapshot_state(self, *, only_pages=None) -> Tuple[Dict, Dict]:
        """Freeze this engine's paged tenant state for migration.

        ``only_pages`` (a set of MMU share keys — ``("d", ppage)`` /
        ``("h", hslot)``) restricts the shipped PAYLOADS to that subset:
        pre-copy migrations pass the final dirty delta.  The header (page
        tables, requests, queue, seed) is always complete.

        Returns ``(header, arrays)``: a JSON-safe header (in-flight and
        queued requests, the MMU page-table snapshot, the gather order of
        the live pages, geometry, the sampling seed) and host arrays (the
        compact KV gather of every shipped live page, preserved
        host-evicted payloads; bf16 as tagged int16 bits).  The engine
        must be quiesced: no concurrent ``step()``.
        """
        # rows still mid-chunk-prefill (no sampled token yet) go back to
        # the queue: the destination re-prefills them, and counter-based
        # sampling keys make their streams the same either way
        reqs = [{"slot": i, **self._req_to_dict(r)}
                for i, r in enumerate(self.slots)
                if r is not None and r.prefill_pos < 0]
        demoted = [r for r in self.slots
                   if r is not None and r.prefill_pos >= 0]
        mmu_snap = self.mmu.snapshot_seqs([r["rid"] for r in reqs])
        # dedupe: each physical page (device ppage / host slot) ships
        # ONCE however many sequences share it — restore_seqs rebuilds
        # the sharing from the per-seq page tables in ``mmu_snap``
        pages, host_pages = [], {}
        seen_pp = set()
        for sd in mmu_snap["seqs"]:
            for p in sd["pages"]:
                if p["on_host"]:
                    hs = int(p.get("host_slot", -1))
                    if (only_pages is not None and hs >= 0
                            and ("h", hs) not in only_pages):
                        continue
                    key = (f"h:{hs}" if hs >= 0
                           else f"u:{sd['seq_id']}:{p['vpage']}")
                    if key in host_pages:
                        continue
                    data = self.mmu.host_page_data(sd["seq_id"],
                                                   p["vpage"])
                    if data is not None:
                        host_pages[key] = weights_to_host(
                            {"k": data["k"], "v": data["v"]})
                elif p["ppage"] not in seen_pp:
                    seen_pp.add(p["ppage"])
                    if (only_pages is not None
                            and ("d", p["ppage"]) not in only_pages):
                        continue
                    pages.append({"ppage": p["ppage"]})
        header = {
            "geometry": self.geometry(),
            "requests": reqs,
            "queue": [self._req_to_dict(r)
                      for r in list(demoted) + list(self.queue)],
            "mmu": mmu_snap,
            "pages": pages,          # gather order of kv_k/kv_v rows
            "seed": int(self.seed),
        }
        arrays: Dict = {}
        if pages:
            flat = flat_page_indices([p["ppage"] for p in pages],
                                     self.cfg.n_layers,
                                     self.mmu.config.n_pages)
            kv = self.gather_kv(flat)
            arrays["kv_k"] = weights_to_host(kv["k"])
            arrays["kv_v"] = weights_to_host(kv["v"])
        if host_pages:
            arrays["host_pages"] = host_pages
        return header, arrays

    def restore_state(self, header: Dict, arrays: Dict, *,
                      staged=None) -> Dict[str, int]:
        """Adopt a migrated tenant: fresh page allocation on OUR MMU,
        block-table rebuild (dirty rows upload on the next view), KV
        payloads scattered onto this engine's device at the new physical
        pages, decode state synced, sampling seed adopted (a container
        without one — the reference's, which carries a JAX PRNG key —
        keeps ours).  In-flight requests land on their original slot
        index when free, else the first free slot.

        ``staged`` (pre-copy): ``{source share key: our ppage}`` of pages
        already filled by warm rounds — forwarded to ``MMU.restore_seqs``
        so those mappings adopt the staged pages; the delta payloads in
        ``arrays`` then overwrite exactly the pages that changed after
        their last warm copy.  (The reference pads the delta scatter to a
        power-of-two bucket to dodge a retrace; eager PyTorch has none.)"""
        g = header["geometry"]
        mine = self.geometry()
        if g != mine:
            raise ValueError(
                f"migration geometry mismatch: snapshot {g} vs "
                f"destination {mine} — KV pages are not byte-compatible")
        reqs = header["requests"]
        free = [i for i in range(self.max_batch)
                if self.slots[i] is None]
        if len(reqs) > len(free):
            raise ValueError(
                f"destination engine has {len(free)} free slots for "
                f"{len(reqs)} in-flight migrated requests")
        mapping = self.mmu.restore_seqs(header["mmu"], slot=self.slot,
                                        staged=staged)
        # shared source pages restored to ONE destination page each:
        # index the new ppage by old device ppage / host slot so every
        # shipped payload (deduped at snapshot) scatters exactly once
        by_old, by_hslot, by_sv = {}, {}, {}
        for sid, pl in mapping.items():
            for p in pl:
                if p["was_host"]:
                    if p["host_slot"] >= 0:
                        by_hslot[p["host_slot"]] = p["new_ppage"]
                    by_sv[(sid, p["vpage"])] = p["new_ppage"]
                else:
                    by_old[p["old_ppage"]] = p["new_ppage"]
        L, n_pages = self.cfg.n_layers, self.mmu.config.n_pages
        if header["pages"]:
            new_pps = [by_old[p["ppage"]] for p in header["pages"]]
            self.scatter_kv(flat_page_indices(new_pps, L, n_pages),
                             {"k": weights_from_host(arrays["kv_k"]),
                              "v": weights_from_host(arrays["kv_v"])})
        for key, data in (arrays.get("host_pages") or {}).items():
            if key.startswith("h:"):
                new_pp = by_hslot[int(key[2:])]
            else:                       # "u:<sid>:<vpage>" legacy pages
                _, sid, vpage = key.split(":")
                new_pp = by_sv[(int(sid), int(vpage))]
            self._pager_scatter(new_pp, data)
        slots_i, rows = [], []
        for rd in reqs:
            req = self._req_from_dict(rd)
            want = int(rd.get("slot", -1))
            i = want if (0 <= want < self.max_batch
                         and self.slots[want] is None) else free[0]
            free.remove(i)
            self.slots[i] = req
            self.block_table.bind(i, req.rid)
            assert req.out_tokens, "in-flight request without prefill"
            slots_i.append(i)
            rows.append((len(req.prompt) + len(req.out_tokens) - 1,
                         req.out_tokens[-1], req.temperature,
                         req.top_k, req.top_p, req.rid))
        if slots_i:
            self._sync_slot_state(slots_i, rows)
        for rd in header["queue"]:
            self.queue.append(self._req_from_dict(rd))
        if "seed" in header:
            self.seed = int(header["seed"])
        adopted = ([r["rid"] for r in reqs]
                   + [r["rid"] for r in header["queue"]])
        if adopted:
            self._rid_next = max(self._rid_next, max(adopted) + 1)
        return {"requests": len(reqs), "queued": len(header["queue"]),
                "pages": len(header["pages"])
                + len(arrays.get("host_pages") or {})}

    def reset_decode_state(self) -> None:
        """Cold-reset the engine's device-side soft state — the local
        analogue of restarting the slot's logic after a crash: a fresh
        block-table view, zeroed lens/tokens/sampling params, dropped
        billed-IO futures, full TLB flush.  KV pool *contents* are not
        touched: :meth:`restore_state` scatters the preserved page
        payloads back in right after, which is what makes a recovery
        KV-intact instead of a re-prefill."""
        self.block_table = self.mmu.block_table_device(
            self.max_batch, self.max_pages, device=self.device)
        for t in (self.dev_lens, self.dev_tokens, self.dev_temps,
                  self.dev_topk, self.dev_rids):
            t.zero_()
        self.dev_topp.fill_(1.0)
        self._topk[:] = 0
        self._topp[:] = 1.0
        self._io_futs = []
        self.mmu.tlb.invalidate()

    def evacuate(self) -> Dict[str, int]:
        """Release the tenant's paged state AFTER a successful snapshot
        restore elsewhere: free every sequence on our MMU (returning the
        pages to the shared pool), unbind block-table rows, clear the
        run queue.  The engine stays usable for new work."""
        freed, n_seqs = [], 0
        for i, req in enumerate(self.slots):
            if req is not None:
                self.mmu.free_seq(req.rid)
                self.block_table.unbind(i)
                self.slots[i] = None
                freed.append(i)
                n_seqs += 1
        if freed:
            self._sync_slot_state(freed, [(0, 0, 0.0, 0, 1.0, 0)] * len(freed))
        n_q = len(self.queue)
        self.queue.clear()
        return {"seqs": n_seqs, "queued": n_q}

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
            # decode-step preemption checkpoint: when this loop is the
            # body of a long-running port invocation on a lane, yield to
            # higher-priority granted work between steps (no-op off-lane)
            if self.shell is not None:
                self.shell.scheduler.checkpoint(self.slot)
        drained = self.flush_io()
        dt = time.perf_counter() - t0
        stats = {"wall_s": dt, "engine_steps": self.steps,
                 "tokens": self.tokens_out,
                 "tokens_per_s": self.tokens_out / max(dt, 1e-9),
                 "completed": len(self.completed),
                 "prefill_computed": self.prefill_computed,
                 "prefill_skipped": self.prefill_skipped}
        stats.update(self.latency_stats())
        if self.shell is not None and self.tenant is not None:
            stats["io_drained"] = drained
            stats["io_pending"] = self.shell.scheduler.tenant_pending(
                self.tenant)
        return stats
