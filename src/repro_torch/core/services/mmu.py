"""MMU service: shared virtual memory with configurable paging (paper §6.1).

Coyote v2's MMU is "implemented in a hybrid manner: TLBs in on-chip SRAM,
the rest in the host-side driver", with parametrizable page size / TLB size /
associativity, GPU-style page-fault migration, and striping across HBM
channels.  The TPU adaptation is a *paged KV-cache manager*:

  * virtual address  = (sequence id, token position)
  * physical address = (page id, offset)       [page id -> pool slot]
  * page table       = per-sequence page list (host side, "driver")
  * TLB              = set-associative SRAM cache of hot translations
  * page fault       = pool page miss -> host callback allocates/migrates,
                       raises IRQ_PAGE_FAULT on the interrupt bus
  * striping         = pages round-robined over N channels (HBM banks)
  * huge pages       = page_size is fully parametric (the 1 GB analogue is
                       a whole-sequence page)
  * shared pages     = physical pages are REFCOUNTED: sequences with a
                       common prompt prefix map the same pages
                       (content-keyed prefix index consulted by
                       ``alloc_seq(prompt_tokens=...)``), and a write
                       translation to a shared page copy-on-writes
                       (``translate(for_write=True)``)

The device-side consumer is the port's CUDA paged-attention kernel
(``repro_torch.kernels.paged_attention``), which walks ``block_table()``
output through :class:`DeviceBlockTable`'s cached copy on the card.  The
host half below is the reference ``repro.core.services.mmu`` unchanged.
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.services.base import Service
from repro_torch.device import resolve_device


@dataclass(frozen=True)
class MMUConfig:
    page_size: int = 256                 # tokens per page (parametric)
    n_pages: int = 4096                  # device pool size
    tlb_entries: int = 256
    tlb_assoc: int = 4
    n_channels: int = 8                  # striping channels (HBM banks)
    host_pool_pages: int = 16384         # host "swap" capacity
    prefix_sharing: bool = True          # content-keyed CoW page sharing


@dataclass
class PageTableEntry:
    vpage: int
    ppage: int                           # device pool slot, -1 if on host
    on_host: bool = False
    host_slot: int = -1


def _chain_hash(prev: str, block: Sequence[int]) -> str:
    """Content key of a token page, chained over the whole prefix: page
    j's hash covers tokens [0, (j+1)*page_size) — exactly the tokens the
    page's KV depends on under causal attention, so equal hash implies
    byte-equal KV for any two sequences."""
    h = hashlib.blake2b(digest_size=16)
    h.update(prev.encode("ascii"))
    h.update(np.asarray(list(block), np.int64).tobytes())
    return h.hexdigest()


@dataclass
class SeqEntry:
    seq_id: int
    length: int = 0
    pages: List[PageTableEntry] = field(default_factory=list)


class TLB:
    """Set-associative translation cache with LRU within each set."""

    def __init__(self, entries: int, assoc: int):
        assoc = max(1, min(assoc, entries))
        self.n_sets = max(1, entries // assoc)
        self.assoc = assoc
        # each set: list of (key, ppage, last_used)
        self._sets: List[List[Tuple[Tuple[int, int], int, int]]] = [
            [] for _ in range(self.n_sets)]
        self._tick = 0
        self.hits = 0
        self.misses = 0

    def _set_of(self, key: Tuple[int, int]) -> int:
        return hash(key) % self.n_sets

    def lookup(self, seq_id: int, vpage: int) -> Optional[int]:
        key = (seq_id, vpage)
        s = self._sets[self._set_of(key)]
        self._tick += 1
        for i, (k, p, _) in enumerate(s):
            if k == key:
                s[i] = (k, p, self._tick)
                self.hits += 1
                return p
        self.misses += 1
        return None

    def insert(self, seq_id: int, vpage: int, ppage: int) -> None:
        key = (seq_id, vpage)
        s = self._sets[self._set_of(key)]
        self._tick += 1
        for i, (k, _, _) in enumerate(s):
            if k == key:
                s[i] = (key, ppage, self._tick)
                return
        if len(s) >= self.assoc:
            s.remove(min(s, key=lambda e: e[2]))     # LRU evict
        s.append((key, ppage, self._tick))

    def invalidate(self, seq_id: Optional[int] = None) -> int:
        n = 0
        for s in self._sets:
            keep = [e for e in s
                    if seq_id is not None and e[0][0] != seq_id]
            n += len(s) - len(keep)
            s[:] = keep
        return n

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 1.0


class PageFaultError(Exception):
    pass


def _share_key(sid: int, p: Dict[str, Any]) -> Tuple:
    """Physical identity of a snapshotted page: snapshot entries with the
    same key were one physical page at the source and restore to one
    page at the destination.  Host pages without a recorded slot (legacy
    snapshots) are conservatively treated as private."""
    if p["on_host"]:
        hslot = int(p.get("host_slot", -1))
        return ("h", hslot) if hslot >= 0 else ("u", sid, int(p["vpage"]))
    return ("d", int(p["ppage"]))


class MMU(Service):
    """The paged-memory service.  Thread-safe; the 'driver' half."""

    NAME = "mmu"
    PORT_METHODS = ("alloc_seq", "extend_seq", "free_seq", "translate",
                    "block_table", "seq_lens", "utilization", "status",
                    "configure", "snapshot_seqs")
    PORT_MEM_MODEL = "paged"

    def __init__(self, config: Optional[MMUConfig] = None,
                 interrupt_post: Optional[Callable[[int, int], None]] = None):
        # None sentinel, NOT `config=MMUConfig()`: a dataclass default in
        # the signature is one shared instance across every default-
        # constructed MMU, so a later in-place configure() could alias
        # shells (frozen today, but the aliasing is a trap)
        super().__init__(config if config is not None else MMUConfig())
        self._lock = threading.RLock()
        self._post = interrupt_post or (lambda slot, val: None)
        # evict-with-copy pager (registered by the page-data owner, e.g.
        # the serving engine): survives reconfigure — it belongs to the
        # owner's lifetime, not the pool's
        self._pager_gather: Optional[Callable[[int], Any]] = None
        self._pager_scatter: Optional[Callable[[int, Any], None]] = None
        self._pager_owner: Any = None
        # armed FaultPlan (wired by Shell.set_fault_plan): probed at the
        # pager sites ("pager.gather"/"pager.scatter") and in force mode
        # at "mmu.page_storm" (simulated pool pressure -> real eviction
        # churn).  Survives configure() — it belongs to the shell.
        self.faults: Optional[Any] = None
        self._in_storm = False        # re-entrancy guard (storm fault-in)
        self._init_pools()

    def _init_pools(self) -> None:
        c: MMUConfig = self.config
        self.tlb = TLB(c.tlb_entries, c.tlb_assoc)
        self._free = list(range(c.n_pages - 1, -1, -1))
        self._host_free = list(range(c.host_pool_pages - 1, -1, -1))
        self._seqs: Dict[int, SeqEntry] = {}
        # per-sequence mapping version: bumped whenever a sequence's page
        # list changes (alloc/extend/evict/migrate), so cached device
        # block-table views re-upload only the rows that actually moved.
        self._map_version: Dict[int, int] = {}
        # host-resident page payloads, keyed by host slot: filled by the
        # pager's gather on evict, drained by scatter on fault-back-in
        self._host_data: Dict[int, Any] = {}
        # copy-on-write prefix sharing: physical pages are refcounted —
        # a device page (or a host slot, after eviction) may back the
        # same vpage of many sequences.  The prefix index maps a chain
        # hash of full prompt-token pages to the canonical physical page
        # holding that prefix's KV; alloc_seq() consults it.
        self._ref: Dict[int, int] = {}            # device ppage -> refs
        self._host_ref: Dict[int, int] = {}       # host slot -> refs
        self._prefix_index: Dict[str, int] = {}   # chain hash -> ppage
        self._page_hash: Dict[int, str] = {}      # ppage -> chain hash
        # pre-copy dirty tracking: physical pages whose CONTENT may have
        # changed since the last ``clear_dirty()``.  Keys match
        # ``_share_key``: ("d", ppage) for device pages, ("h", hslot)
        # for host-resident payloads.  Marked on fresh allocation, token
        # appends (``extend_seq`` tail pages), write translations, CoW
        # copies and prefill writes (``mark_dirty_range``); transferred
        # device<->host on evict/fault-in; dropped when the last
        # reference dies.  One MMU backs one paged engine (enforced by
        # ``register_pager``), so the set is per-tenant.
        self._dirty: set = set()
        self.page_faults = 0
        self.migrations_out = 0
        self.migrations_in = 0
        self.prefix_hits = 0                      # pages mapped shared
        self.cow_faults = 0                       # CoW page copies

    def _bump_map(self, seq_id: int) -> None:
        self._map_version[seq_id] = self._map_version.get(seq_id, 0) + 1

    # -- reconfiguration (paper scenario #1: swap 2 MB -> 1 GB pages) -------
    def configure(self, config: MMUConfig) -> None:
        with self._lock:
            if self._seqs:
                raise RuntimeError(
                    "MMU reconfigure with live sequences; drain first "
                    "(the shell checks app requirements before this)")
            super().configure(config)
            self._init_pools()

    # -- allocation -----------------------------------------------------------
    def alloc_seq(self, seq_id: int, n_tokens: int = 0, *, slot: int = 0,
                  prompt_tokens: Optional[Sequence[int]] = None,
                  publish: bool = True) -> int:
        """Allocate a sequence of ``n_tokens``; returns the number of
        prompt tokens whose pages were mapped SHARED (0 without sharing).

        With ``prompt_tokens`` and ``config.prefix_sharing``, every full
        page of the prompt is looked up in the content-keyed prefix
        index: a hit maps the existing physical page with
        ``refcount += 1`` instead of allocating — the caller may then
        skip prefill compute for the covered prefix entirely.  Full
        pages that miss are allocated privately and REGISTERED under
        their chain hash; the allocator owns filling them with the
        prefix's KV in the same admission pass (the serving engine's
        prefill does), which is what makes them canonical for later
        sequences.

        ``publish=False`` defers that registration: the sequence still
        CONSUMES existing shared pages, but its own pages only become
        canonical when the caller invokes :meth:`publish_prefix` — the
        contract chunked prefill needs, where page *mappings* exist at
        admission but their KV *content* lands over several later steps
        and must not be consumed by other sequences in between.
        """
        hashes: List[str] = []
        if prompt_tokens is not None and self.config.prefix_sharing:
            ps = self.config.page_size
            h = ""
            for j in range(len(prompt_tokens) // ps):
                h = _chain_hash(h, prompt_tokens[j * ps:(j + 1) * ps])
                hashes.append(h)
        covered = 0
        with self._lock:
            if seq_id in self._seqs:
                raise KeyError(f"seq {seq_id} already allocated")
            se = SeqEntry(seq_id=seq_id)
            self._seqs[seq_id] = se
            self._map_version[seq_id] = 0
            for j, h in enumerate(hashes):
                pp = self._prefix_index.get(h)
                if pp is None:
                    break
                se.pages.append(PageTableEntry(vpage=j, ppage=pp))
                self._ref[pp] = self._ref.get(pp, 0) + 1
                covered += self.config.page_size
                self.prefix_hits += 1
            if covered:
                se.length = covered
                self._bump_map(seq_id)
        if n_tokens > covered:
            self.extend_seq(seq_id, n_tokens - covered, slot=slot)
        if hashes and publish:
            self._register_prefix(seq_id, hashes,
                                  covered // self.config.page_size)
        return covered

    def _register_prefix(self, seq_id: int, hashes: List[str],
                         first_page: int) -> None:
        """Make a sequence's private full prompt pages canonical for the
        prefix index (pages before ``first_page`` were mapped shared)."""
        with self._lock:
            se = self._seqs.get(seq_id)
            for j in range(first_page, len(hashes)):
                if se is None or j >= len(se.pages):
                    break
                pte = se.pages[j]
                if (pte.on_host or pte.ppage < 0
                        or pte.ppage in self._page_hash
                        or hashes[j] in self._prefix_index):
                    continue
                self._prefix_index[hashes[j]] = pte.ppage
                self._page_hash[pte.ppage] = hashes[j]

    def publish_prefix(self, seq_id: int,
                       prompt_tokens: Sequence[int]) -> None:
        """Deferred half of ``alloc_seq(..., publish=False)``: register
        the sequence's full prompt pages in the prefix index once their
        KV content is actually resident (the serving engine calls this
        when a chunked prefill lands its final chunk).  A no-op for
        freed sequences and with sharing disabled."""
        if not self.config.prefix_sharing:
            return
        ps = self.config.page_size
        hashes: List[str] = []
        h = ""
        for j in range(len(prompt_tokens) // ps):
            h = _chain_hash(h, prompt_tokens[j * ps:(j + 1) * ps])
            hashes.append(h)
        self._register_prefix(seq_id, hashes, 0)

    def probe_prefix(self, prompt_tokens: Sequence[int]) -> int:
        """How many leading prompt tokens the prefix index would map to
        shared pages RIGHT NOW, without allocating anything — admission
        control uses this to charge a templated request only for its
        uncovered suffix."""
        if not self.config.prefix_sharing:
            return 0
        ps = self.config.page_size
        covered = 0
        h = ""
        with self._lock:
            for j in range(len(prompt_tokens) // ps):
                h = _chain_hash(h, prompt_tokens[j * ps:(j + 1) * ps])
                if h not in self._prefix_index:
                    break
                covered += ps
        return covered

    def extend_seq(self, seq_id: int, n_tokens: int, *, slot: int = 0) -> None:
        """Grow a sequence; allocates pages on demand (the page-fault path
        when the pool is exhausted triggers host eviction)."""
        c: MMUConfig = self.config
        with self._lock:
            se = self._seqs[seq_id]
            se.length += n_tokens
            need = -(-se.length // c.page_size)          # ceil
            grew = len(se.pages) < need
            while len(se.pages) < need:
                ppage = self._take_device_page(seq_id, slot)
                se.pages.append(PageTableEntry(
                    vpage=len(se.pages), ppage=ppage))
            if grew:
                self._bump_map(seq_id)
            if n_tokens > 0 and se.pages:
                # an append means the engine just wrote (or is about to
                # write) KV at the tail: the page holding position
                # old_length-1 (the token the decode step landed) and
                # the new tail page are dirty for pre-copy purposes
                lo = max(se.length - n_tokens - 1, 0) // c.page_size
                for vp in range(lo, min(need, len(se.pages))):
                    p = se.pages[vp]
                    self._dirty.add(("h", p.host_slot) if p.on_host
                                    else ("d", p.ppage))

    def _take_device_page(self, seq_id: int, slot: int) -> int:
        if (self._free and self.faults is not None and not self._in_storm
                and self.faults.force("mmu.page_storm",
                                      slot=slot) is not None):
            # page-fault storm (behavioural fault): one FULL evict-with-
            # copy round trip — a victim page gathers out to the host
            # store and immediately faults back in (fresh page, payload
            # scattered back).  Real pager churn, real IRQs and counter
            # movement, byte-identical decode: the victim row never sees
            # a host-resident (-1) block-table entry.
            victim = self._pick_victim(exclude=seq_id)
            target = None
            if victim is not None:
                target = next((p for p in
                               reversed(self._seqs[victim].pages)
                               if not p.on_host), None)
            if target is not None:
                self._in_storm = True     # the fault-in allocates through
                try:                      # us again: no recursive storms
                    self.page_faults += 1
                    self._post(slot, seq_id)             # IRQ_PAGE_FAULT
                    self._evict_seq_page(victim)
                    if target.on_host:
                        self._fault_in(victim, target, slot)
                finally:
                    self._in_storm = False
        if not self._free:
            self.page_faults += 1
            self._post(slot, seq_id)                     # IRQ_PAGE_FAULT
            victim = self._pick_victim(exclude=seq_id)
            if victim is None:
                raise PageFaultError("device page pool exhausted and no "
                                     "victim sequence to evict")
            self._evict_seq_page(victim)
            if not self._free:
                raise PageFaultError("eviction failed to free a page")
        pp = self._free.pop()
        self._ref[pp] = 1
        self._dirty.add(("d", pp))    # fresh pages carry new content
        return pp

    def _pick_victim(self, exclude: int) -> Optional[int]:
        # evict from the longest resident sequence (simple, deterministic)
        best, best_len = None, -1
        for sid, se in self._seqs.items():
            if sid == exclude:
                continue
            resident = sum(1 for p in se.pages if not p.on_host)
            if resident > best_len and resident > 0:
                best, best_len = sid, resident
        return best

    # -- evict-with-copy pager ------------------------------------------------
    def register_pager(self, gather: Callable[[int], Any],
                       scatter: Callable[[int, Any], None],
                       owner: Any = None) -> None:
        """Register the page-data mover for REAL KV migration on evict.

        ``gather(ppage)`` returns the page's payload (e.g. the serving
        engine's (n_layers, page_size, K, hd) KV slab for that physical
        page) *before* the device page is freed; ``scatter(ppage, data)``
        writes a preserved payload into a freshly allocated device page
        on fault-back-in.  Without a pager, eviction falls back to the
        old mapping-only behaviour (page contents are lost and the row
        decodes degraded until re-prefilled).

        ONE pager per MMU — and this is enforced: the pager closes over
        the single paged-pool owner, so a second distinct ``owner``
        (e.g. a second ServingEngine sharing this MMU) is refused rather
        than silently gathering/scattering through the wrong pools and
        corrupting both tenants' KV.  Give each paged engine its own MMU
        instance, or :meth:`unregister_pager` the old owner first.
        """
        with self._lock:
            if (self._pager_owner is not None and owner is not None
                    and owner is not self._pager_owner):
                raise RuntimeError(
                    "this MMU already has an evict-with-copy pager "
                    f"(owner {self._pager_owner!r}); a second paged-pool "
                    "owner on one MMU would corrupt both pools on "
                    "evict — give each engine its own MMU, or "
                    "unregister_pager() the old owner first")
            self._pager_gather = gather
            self._pager_scatter = scatter
            self._pager_owner = owner

    def unregister_pager(self, owner: Any = None) -> None:
        """Drop the pager (the owner is being torn down/replaced).
        Already-preserved host payloads stay restorable only as raw
        data; future evictions fall back to mapping-only."""
        with self._lock:
            if owner is not None and owner is not self._pager_owner:
                return                       # not yours to drop
            self._pager_gather = None
            self._pager_scatter = None
            self._pager_owner = None

    def host_page_data(self, seq_id: int, vpage: int) -> Optional[Any]:
        """The preserved payload of a host-resident page (None when the
        page is device-resident or was evicted without a pager)."""
        with self._lock:
            se = self._seqs.get(seq_id)
            if se is None or vpage >= len(se.pages):
                return None
            pte = se.pages[vpage]
            if not pte.on_host:
                return None
            return self._host_data.get(pte.host_slot)

    def _evict_seq_page(self, seq_id: int) -> None:
        se = self._seqs[seq_id]
        for pte in reversed(se.pages):                   # evict tail first
            if not pte.on_host:
                if not self._host_free:
                    raise PageFaultError("host pool exhausted")
                pp = pte.ppage
                data = None
                if self._pager_gather is not None:
                    # REAL migration: copy the page payload to the host
                    # store before the device page is recycled.  Gather
                    # runs BEFORE any pool state mutates — a failing
                    # gather (or an injected "pager.gather" fault) leaves
                    # the mapping and both pools exactly as they were.
                    if self.faults is not None:
                        self.faults.fire("pager.gather", ppage=pp)
                    data = self._pager_gather(pp)
                hslot = self._host_free.pop()
                if data is not None:
                    self._host_data[hslot] = data
                # a shared page moves for EVERY sharer at once: one host
                # slot backs the group, refcount transfers device->host
                sharers = set()
                for sid2, se2 in self._seqs.items():
                    for p2 in se2.pages:
                        if not p2.on_host and p2.ppage == pp:
                            p2.on_host = True
                            p2.host_slot = hslot
                            p2.ppage = -1
                            sharers.add(sid2)
                self._host_ref[hslot] = max(self._ref.pop(pp, 1),
                                            len(sharers))
                # dirty state follows the content to its new identity;
                # the freed device page stops being dirty either way
                if ("d", pp) in self._dirty:
                    self._dirty.add(("h", hslot))
                self._dirty.discard(("d", pp))
                self._unregister_page(pp)    # evicted pages leave the
                self._free.append(pp)        # prefix index: no new shares
                self.migrations_out += 1
                for sid2 in sharers:
                    self.tlb.invalidate(sid2)
                    self._bump_map(sid2)
                return

    def _unregister_page(self, ppage: int) -> None:
        h = self._page_hash.pop(ppage, None)
        if h is not None and self._prefix_index.get(h) == ppage:
            self._prefix_index.pop(h, None)

    def _drop_host_ref(self, hslot: int) -> None:
        """Release one reference to a host slot; the stored payload is
        dropped only when the LAST reference dies (shared pages evicted
        to host stay restorable for every surviving sharer)."""
        n = self._host_ref.get(hslot, 1) - 1
        if n <= 0:
            self._host_ref.pop(hslot, None)
            self._host_free.append(hslot)
            self._host_data.pop(hslot, None)
            self._dirty.discard(("h", hslot))
        else:
            self._host_ref[hslot] = n

    def _drop_page_ref(self, ppage: int) -> None:
        """Release one reference to a device page; recycle it into the
        free pool only at refcount 0."""
        n = self._ref.get(ppage, 1) - 1
        if n <= 0:
            self._ref.pop(ppage, None)
            self._unregister_page(ppage)
            self._free.append(ppage)
            self._dirty.discard(("d", ppage))
        else:
            self._ref[ppage] = n

    def free_seq(self, seq_id: int) -> None:
        with self._lock:
            se = self._seqs.pop(seq_id)
            self._map_version.pop(seq_id, None)
            for pte in se.pages:
                if pte.on_host:
                    self._drop_host_ref(pte.host_slot)
                else:
                    self._drop_page_ref(pte.ppage)
            n = self.tlb.invalidate(seq_id)
            if n:
                self._post(0, seq_id)                    # TLB invalidation

    # -- translation -----------------------------------------------------------
    def translate(self, seq_id: int, token_pos: int, *,
                  slot: int = 0, for_write: bool = False) -> Tuple[int, int]:
        """(seq, pos) -> (physical page, offset).  TLB first, then the
        driver walk; host-resident pages fault back in.

        ``for_write`` declares intent to MUTATE the page: a translation
        that lands on a shared page (refcount > 1) then triggers
        copy-on-write — a fresh page is allocated, the payload is copied
        device-side through the registered pager hooks, this sequence is
        remapped to the private copy and the shared page's refcount
        drops.  Other sharers keep reading the original bytes.  Write
        translations bypass the TLB fast path (a cached translation
        cannot see the refcount)."""
        c: MMUConfig = self.config
        vpage, off = divmod(token_pos, c.page_size)
        if not for_write:
            ppage = self.tlb.lookup(seq_id, vpage)
            if ppage is not None:
                return ppage, off
        with self._lock:                                 # driver walk
            se = self._seqs.get(seq_id)
            if se is None or vpage >= len(se.pages):
                raise PageFaultError(f"unmapped: seq {seq_id} page {vpage}")
            pte = se.pages[vpage]
            if pte.on_host:                              # migrate back in
                self._fault_in(seq_id, pte, slot)
            if for_write and self._ref.get(pte.ppage, 1) > 1:
                self._cow(seq_id, pte, slot)
            if for_write:
                # declared mutation: the page is dirty for pre-copy
                self._dirty.add(("d", pte.ppage))
            self.tlb.insert(seq_id, vpage, pte.ppage)
            return pte.ppage, off

    def _fault_in(self, seq_id: int, pte: PageTableEntry,
                  slot: int) -> None:
        """Bring a host-resident page back onto the device — for EVERY
        sharer of its host slot at once (they reference the same bytes;
        one fresh page serves the group, refcount transfers host->device
        and the preserved payload is drained exactly once)."""
        self.page_faults += 1
        self._post(slot, seq_id)
        hslot = pte.host_slot
        new_pp = self._take_device_page(seq_id, slot)
        try:
            data = self._host_data.get(hslot)
            if data is not None and self._pager_scatter is not None:
                if self.faults is not None:
                    self.faults.fire("pager.scatter", slot=slot,
                                     hslot=hslot)
                # restore the preserved payload into the fresh page
                self._pager_scatter(new_pp, data)
        except BaseException:
            # a failed scatter (or injected "pager.scatter" fault) must
            # not leak the fresh page or drop the preserved payload: the
            # mapping stays host-resident and a later translate retries
            self._ref.pop(new_pp, None)
            self._free.append(new_pp)
            raise
        self._host_data.pop(hslot, None)
        sharers = set()
        for sid2, se2 in self._seqs.items():
            for p2 in se2.pages:
                if p2.on_host and p2.host_slot == hslot:
                    p2.on_host = False
                    p2.host_slot = -1
                    p2.ppage = new_pp
                    sharers.add(sid2)
        self._ref[new_pp] = max(self._host_ref.pop(hslot, 1),
                                len(sharers))
        self._host_free.append(hslot)
        # content moved to the (already-dirty) fresh device page
        self._dirty.discard(("h", hslot))
        self.migrations_in += 1
        for sid2 in sharers:
            self.tlb.invalidate(sid2)
            self._bump_map(sid2)

    def _cow(self, seq_id: int, pte: PageTableEntry, slot: int) -> None:
        """Copy-on-write: detach ``seq_id``'s mapping of a shared page
        onto a private copy.  The payload is gathered BEFORE the new
        page is taken — the allocation may evict the shared page (moving
        this very mapping to host), and the pre-gathered bytes stay
        valid either way."""
        old = pte.ppage
        payload = None
        if self._pager_gather is not None:
            # before any state mutates: a failing gather (or injected
            # "pager.gather" fault) leaves the shared mapping intact
            if self.faults is not None:
                self.faults.fire("pager.gather", slot=slot, ppage=old)
            payload = self._pager_gather(old)
        new_pp = self._take_device_page(seq_id, slot)
        if pte.on_host:
            # the allocation above evicted the shared group (us included)
            # to host: release our host reference, adopt the fresh page
            self._drop_host_ref(pte.host_slot)
            pte.on_host = False
            pte.host_slot = -1
        else:
            self._drop_page_ref(old)
        pte.ppage = new_pp
        if payload is not None and self._pager_scatter is not None:
            self._pager_scatter(new_pp, payload)
        self.cow_faults += 1
        self.tlb.invalidate(seq_id)
        self._bump_map(seq_id)

    # -- device-side views ------------------------------------------------------
    def block_table(self, seq_ids: List[int], max_pages: int) -> np.ndarray:
        """(n_seqs, max_pages) int32 physical page ids, -1 padded — the
        array the paged-attention kernel walks."""
        out = np.full((len(seq_ids), max_pages), -1, np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                se = self._seqs.get(sid)
                if se is None:
                    continue
                for pte in se.pages[:max_pages]:
                    out[i, pte.vpage] = -1 if pte.on_host else pte.ppage
        return out

    def seq_lens(self, seq_ids: List[int]) -> np.ndarray:
        with self._lock:
            return np.array([self._seqs[s].length if s in self._seqs else 0
                             for s in seq_ids], np.int32)

    def seq_map_version(self, seq_id: int) -> int:
        """Monotone per-sequence mapping version (-1 = not allocated).
        Changes iff the sequence's page list changed."""
        with self._lock:
            return self._map_version.get(seq_id, -1)

    def block_table_device(self, n_slots: int, max_pages: int, *,
                           device=None) -> "DeviceBlockTable":
        """A cached device-resident block-table view over a fixed window
        of engine slots — the steady-state decode step reads a device
        tensor that is already there; only rows whose mapping changed
        (alloc/extend/free/evict deltas) are re-uploaded.  ``device``
        defaults to the CUDA card.  Under tensor parallelism every rank
        builds its own view of its own (replicated) MMU: the tables are
        the same on every rank, as the reference's replicated sharding."""
        return DeviceBlockTable(self, n_slots, max_pages, device=device)

    def channel_of(self, ppage: int) -> int:
        """Striping: which channel (HBM bank) a page lives on."""
        return ppage % self.config.n_channels

    # -- migration snapshot / restore (quiesce-and-migrate) ---------------------
    def snapshot_seqs(self, seq_ids: List[int]) -> Dict[str, Any]:
        """JSON-safe page-table snapshot of a tenant's sequences — the
        MMU half of a migration state container.  Captures lengths and
        per-page mapping state (vpage order, device ppage, host
        residency + host slot so shared pages stay groupable, and the
        prefix-index chain hash when the page is content-registered);
        page *payloads* are gathered separately by the pool owner
        (``repro.serve.paged_model.gather_kv_pages``) — ONCE per
        physical page, however many sequences share it."""
        with self._lock:
            seqs = []
            for sid in seq_ids:
                se = self._seqs[sid]
                pages = []
                for p in se.pages:
                    pd = {"vpage": int(p.vpage), "ppage": int(p.ppage),
                          "on_host": bool(p.on_host),
                          "host_slot": int(p.host_slot)}
                    h = self._page_hash.get(p.ppage) if not p.on_host \
                        else None
                    if h is not None:
                        pd["hash"] = h
                    pages.append(pd)
                seqs.append({"seq_id": int(sid), "length": int(se.length),
                             "pages": pages})
            return {"page_size": int(self.config.page_size), "seqs": seqs}

    def restore_seqs(self, snap: Dict[str, Any], *, slot: int = 0,
                     staged: Optional[Dict[Tuple, int]] = None
                     ) -> Dict[int, List[Dict[str, int]]]:
        """Rebuild snapshotted sequences on THIS MMU with fresh device
        pages (every page comes back device-resident, including pages
        that were host-evicted at the source).

        Returns ``{seq_id: [{"vpage", "old_ppage", "new_ppage",
        "was_host", "host_slot"}, ...]}`` — the page map the caller uses
        to scatter the migrated KV payload into the destination pools
        (``old_ppage`` is -1 for pages that were host-resident).
        SHARING IS PRESERVED: snapshot pages backed by the same source
        physical page (same device ppage, or same host slot) restore to
        ONE destination page with the refcount rebuilt, so a migrated
        fleet of templated tenants never explodes capacity; pages
        carrying a prefix-index chain hash are re-registered so future
        allocations on this MMU share them too.  Page-size geometry must
        match; colliding sequence ids are refused (migrating tenants
        must use disjoint id ranges, ``ServingEngine(rid_base=...)``).

        ``staged`` is the pre-copy hand-off: ``{share_key: ppage}`` for
        pages already reserved (``reserve_pages``) and filled by warm
        rounds.  A snapshot page whose source share-key appears in
        ``staged`` ADOPTS that page instead of allocating a fresh one —
        its reservation reference becomes the first mapping reference,
        so the caller must NOT also release adopted pages.
        """
        if int(snap.get("page_size", -1)) != self.config.page_size:
            raise PageFaultError(
                f"page-size mismatch: snapshot has "
                f"{snap.get('page_size')}, this MMU has "
                f"{self.config.page_size} — cannot restore page tables "
                "across page geometries")
        mapping: Dict[int, List[Dict[str, int]]] = {}
        with self._lock:
            keys = set()
            for sd in snap["seqs"]:
                sid = int(sd["seq_id"])
                if sid in self._seqs:
                    raise KeyError(
                        f"seq {sid} already allocated on the destination "
                        "MMU (sequence id collision — use disjoint "
                        "rid_base ranges per tenant)")
                for p in sd["pages"]:
                    keys.add(_share_key(sid, p))
            # demand upfront capacity for the UNIQUE page set: restoring
            # THROUGH the eviction path could evict pages allocated
            # earlier in this very restore (the returned mapping would
            # dangle) — an incoming tenant must fit, it never steals
            # resident tenants' pages
            need = len(keys if staged is None
                       else keys - set(staged.keys()))
            if need > len(self._free):
                raise PageFaultError(
                    f"destination pool has {len(self._free)} free pages "
                    f"for a {need}-page incoming tenant; migration "
                    "needs upfront capacity (free sequences or use a "
                    "larger pool)")
            new_map: Dict[Tuple[str, int], int] = {}
            for sd in snap["seqs"]:
                sid = int(sd["seq_id"])
                se = SeqEntry(seq_id=sid, length=int(sd["length"]))
                pages = []
                for p in sorted(sd["pages"], key=lambda x: x["vpage"]):
                    hslot = int(p.get("host_slot", -1))
                    key = _share_key(sid, p)
                    if key in new_map:                 # shared at source:
                        new_pp = new_map[key]          # re-share here
                        self._ref[new_pp] = self._ref.get(new_pp, 0) + 1
                    else:
                        if staged is not None and key in staged:
                            # adopt the warm-round page: its reservation
                            # ref (1) becomes this first mapping ref
                            new_pp = staged[key]
                        else:
                            new_pp = self._take_device_page(sid, slot)
                        new_map[key] = new_pp
                        h = p.get("hash")
                        if h and h not in self._prefix_index:
                            self._prefix_index[h] = new_pp
                            self._page_hash[new_pp] = h
                    se.pages.append(PageTableEntry(vpage=int(p["vpage"]),
                                                   ppage=new_pp))
                    pages.append({"vpage": int(p["vpage"]),
                                  "old_ppage": int(p["ppage"]),
                                  "new_ppage": new_pp,
                                  "was_host": bool(p["on_host"]),
                                  "host_slot": hslot})
                self._seqs[sid] = se
                self._map_version[sid] = 0
                self._bump_map(sid)
                mapping[sid] = pages
        return mapping

    # -- pre-copy dirty tracking / staging ---------------------------------------
    def mark_dirty_range(self, seq_id: int, start: int, end: int) -> None:
        """Mark the pages covering token positions ``[start, end)`` as
        dirty.  The engine calls this after landing prefill KV writes —
        those writes go straight through the pager into pages allocated
        earlier, so allocation-time marks alone could be cleared by a
        pre-copy round that runs between the alloc and the write."""
        if end <= start:
            return
        c: MMUConfig = self.config
        with self._lock:
            se = self._seqs.get(seq_id)
            if se is None:
                return
            for vp in range(start // c.page_size,
                            min(-(-end // c.page_size), len(se.pages))):
                p = se.pages[vp]
                self._dirty.add(("h", p.host_slot) if p.on_host
                                else ("d", p.ppage))

    def dirty_snapshot(self) -> set:
        """The current dirty-page key set (a copy; does NOT clear —
        pre-copy peeks first, then clears only once it commits to
        shipping this round)."""
        with self._lock:
            return set(self._dirty)

    def clear_dirty(self) -> None:
        with self._lock:
            self._dirty.clear()

    def live_page_keys(self, seq_ids: Optional[List[int]] = None) -> set:
        """Share keys (``("d", ppage)`` / ``("h", hslot)``) of every page
        currently mapped by ``seq_ids`` (default: all sequences)."""
        with self._lock:
            out = set()
            sids = self._seqs.keys() if seq_ids is None else seq_ids
            for sid in sids:
                se = self._seqs.get(sid)
                if se is None:
                    continue
                for p in se.pages:
                    if p.on_host:
                        out.add(("h", p.host_slot) if p.host_slot >= 0
                                else ("u", sid, p.vpage))
                    else:
                        out.add(("d", p.ppage))
            return out

    def reserve_pages(self, n: int) -> List[int]:
        """Take ``n`` device pages out of the free pool for pre-copy
        staging (refcount 1, no sequence mapping).  Never applies
        eviction pressure — staging must not disturb resident tenants —
        so it raises ``PageFaultError`` when the free pool is short."""
        with self._lock:
            if n > len(self._free):
                raise PageFaultError(
                    f"cannot reserve {n} staging pages: only "
                    f"{len(self._free)} free (pre-copy staging never "
                    "evicts resident tenants)")
            pps = [self._free.pop() for _ in range(n)]
            for pp in pps:
                self._ref[pp] = 1
            return pps

    def release_pages(self, ppages: List[int]) -> None:
        """Return reserved staging pages (one reference each)."""
        with self._lock:
            for pp in ppages:
                self._drop_page_ref(pp)

    def host_payload(self, hslot: int) -> Optional[Any]:
        """The preserved payload stored in a host slot (None when the
        slot was evicted without a pager)."""
        with self._lock:
            return self._host_data.get(hslot)

    # -- introspection -----------------------------------------------------------
    def utilization(self) -> Dict[str, Any]:
        with self._lock:
            c: MMUConfig = self.config
            used = c.n_pages - len(self._free)
            return {
                "pages_used": used, "pages_total": c.n_pages,
                "host_pages_used": c.host_pool_pages - len(self._host_free),
                "sequences": len(self._seqs),
                "tlb_hit_rate": self.tlb.hit_rate,
                "page_faults": self.page_faults,
                "migrations_out": self.migrations_out,
                "migrations_in": self.migrations_in,
                # CoW prefix sharing: how much physical memory the
                # refcounts are multiplying
                "pages_shared": sum(1 for r in self._ref.values() if r > 1),
                "shared_mappings": sum(r - 1 for r in self._ref.values()
                                       if r > 1),
                "prefix_hits": self.prefix_hits,
                "cow_faults": self.cow_faults,
                "dirty_pages": len(self._dirty),
            }

    def status(self) -> Dict[str, Any]:
        s = super().status()
        s.update(self.utilization())
        return s


class DeviceBlockTable:
    """Incremental device mirror of the MMU block table for a slot window.

    The serving engine binds a sequence id to each slot; ``device_view()``
    returns a (n_slots, max_pages) int32 tensor on ``device``, re-uploading
    only the rows whose MMU mapping version changed since the last call
    (one ``index_copy_`` of the dirty rows).  In steady-state decode (no
    page-boundary crossing, no slot churn) the call is a pure cache hit:
    zero host->device traffic.
    """

    def __init__(self, mmu: "MMU", n_slots: int, max_pages: int, *,
                 device=None):
        self.mmu = mmu
        self.n_slots = n_slots
        self.max_pages = max_pages
        self.device = resolve_device(device)
        self._seq = [-1] * n_slots                    # slot -> seq id
        self._ver = [-2] * n_slots                    # last-seen map version
        self._host = np.full((n_slots, max_pages), -1, np.int32)
        self._dev = None
        self._stale = set(range(n_slots))
        self.row_uploads = 0                          # rows re-uploaded
        self.hits = 0                                 # pure cache hits
        self.last_updated_rows: list = []             # rows synced last view

    def bind(self, slot: int, seq_id: int) -> None:
        self._seq[slot] = seq_id
        self._ver[slot] = -2                          # force refresh
        self._stale.add(slot)

    def unbind(self, slot: int) -> None:
        self._seq[slot] = -1
        self._ver[slot] = -2
        self._host[slot] = -1
        self._stale.add(slot)

    def device_view(self) -> torch.Tensor:
        """(n_slots, max_pages) int32 device tensor, incrementally synced."""
        for i, sid in enumerate(self._seq):
            if sid < 0:
                continue
            v = self.mmu.seq_map_version(sid)
            if v != self._ver[i]:
                self._host[i] = self.mmu.block_table(
                    [sid], self.max_pages)[0]
                self._ver[i] = v
                self._stale.add(i)
        if self._dev is None:
            self._dev = torch.from_numpy(self._host.copy()).to(self.device)
            self.row_uploads += self.n_slots
            self.last_updated_rows = list(range(self.n_slots))
            self._stale.clear()
        elif self._stale:
            rows = sorted(self._stale)
            self._dev.index_copy_(
                0, torch.tensor(rows, dtype=torch.long, device=self.device),
                torch.from_numpy(self._host[rows]).to(self.device))
            self.row_uploads += len(rows)
            self.last_updated_rows = rows
            self._stale.clear()
        else:
            self.hits += 1
            self.last_updated_rows = []
        return self._dev
