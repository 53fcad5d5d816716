"""Quiesce-and-migrate: live tenant relocation across shells.

Twin of ``repro.core.migrate``, on the port's engine and MMU.  What
differs: the KV payloads are torch tensors on the engines' devices, so
every payload crosses the container as host numpy with bf16 as tagged
int16 bits (``repro_torch.core.host_codec.weights_to_host``, the port's one
encoding) and lands on the destination engine's device; the container
carries the source engine's sampling seed in place of the reference's
JAX PRNG key, so sampled streams continue exactly; and the reference's
power-of-two padding of the freeze's delta transfers (a guard against
JIT retraces) has no counterpart in eager PyTorch.  The header layout and
``MIGRATION_STATE_VERSION`` are the reference's, so a reference container
restores into a port engine (greedy streams continue; its PRNG key is
ignored).

Coyote v2's reconfiguration story is that services and user logic move
while the system keeps serving.  ``Shell.reconfigure`` already hot-swaps
ONE slot in place (drain -> snapshot -> load -> restore -> replay); this
module completes the story by moving a *paged serving tenant* between two
shells — the checkpoint-based relocation primitive of SYNERGY/RC3E built
on the same Port drain machinery:

  1. **Quiesce** — the source slot's port stops intake (new submissions
     are *held*, never rejected), the in-flight tail completes, and the
     tenant's billed link traffic drains (``scheduler.drain_tenant`` —
     tenant-aware: bystander tenants keep flowing untouched).
  2. **Snapshot** — a versioned, pickle-free state container in the safe
     bitstream format (``kind="migration"``): CSR file + cThread address
     map, the MMU page-table snapshot, in-flight/queued requests, the
     sampling seed, and *the actual KV pool pages* — a device-side compact
     gather of the tenant's live pages into a transfer buffer
     (``ServingEngine.gather_kv``: every KV head, also from a
     tensor-parallel engine), plus any payloads the
     evict-with-copy pager already holds on the host.
  3. **Restore** — fresh page allocation on the destination MMU
     (``MMU.restore_seqs``), KV payload scattered to the new physical
     pages, ``DeviceBlockTable`` rows rebuilt (dirty-row upload on the
     next device view), decode state and sampling seed adopted, CSR/addr-map
     applied to the destination slot.
  4. **Replay** — invocations held at the source during the move are
     re-ticketed and dispatched on the DESTINATION port, resolving their
     original futures: zero lost, zero duplicated completions across the
     migration boundary.

Every ``migrate()`` round-trips the snapshot through the container
encode/decode, so what lands on the destination is exactly what a
wire/disk copy would carry — and the version check runs on every move.

:func:`migrate_precopy` is the low-downtime variant: **warm rounds**
ship KV pages through the chunked container stream while the source
keeps decoding (the MMU's dirty tracking tells each round which pages
changed since the last one — see ``MMU.dirty_snapshot``), landing them
in pages *reserved* on the destination (``MMU.reserve_pages``).  Only
the **freeze** pauses intake, and it snapshots just the final dirty
delta plus CSR/queue/seed state (``snapshot_tenant(only_pages=...)``) —
the destination adopts the staged pages during ``restore_seqs``, so the
service gap is O(dirty delta) instead of O(KV footprint).  A failure in
any warm round releases the staged pages and leaves the source serving,
untouched; freeze-phase failures contain exactly like ``migrate()``.

    from repro_torch.core.migrate import migrate
    report = migrate(src_shell, dst_shell, "gold")      # tenant or slot
    print(report.downtime_s, report.payload_bytes)

On the card: ``chip_smoke.py`` phase 12.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core import bitstream as B
from repro_torch.core.bitstream import BitstreamError
from repro_torch.core.faults import FaultKind, maybe_fire
from repro_torch.core.host_codec import weights_to_host
from repro_torch.core.services.mmu import _share_key

# Bumped whenever the migration header/array layout changes; a snapshot
# from a different version is refused (BitstreamError), never guessed at.
# v2: shared-page dedup — ``header["pages"]`` lists each physical page
# once (``{"ppage"}`` entries, no per-seq duplicates), host payloads key
# by host slot (``"h:<slot>"``), and the MMU snapshot carries per-page
# host_slot + prefix-index chain hashes so restore rebuilds sharing.
MIGRATION_STATE_VERSION = 2


class MigrationError(RuntimeError):
    """Migration pipeline failure (the source is left serving)."""


@dataclass
class MigrationReport:
    """What one ``migrate()`` did and what it cost.

    ``downtime_s`` is the tenant-observed service gap: first intake hold
    at the source to held-invocation replay completing on the
    destination.  Bystander tenants see none of it."""
    tenant: Optional[str]
    src_slot: int
    dst_slot: int
    n_requests: int          # in-flight requests moved
    n_queued: int            # queued requests moved
    n_pages: int             # KV pages copied (device + host-preserved)
    payload_bytes: int       # encoded snapshot container size
    replayed: int            # held invocations replayed on the dst port
    quiesce_s: float
    snapshot_s: float
    restore_s: float
    replay_s: float
    downtime_s: float
    # pre-copy extras (zero for plain stop-and-copy migrate())
    precopy_rounds: int = 0      # warm rounds shipped before the freeze
    precopy_pages: int = 0       # page payloads shipped warm (re-ships count)
    precopy_bytes: int = 0       # warm-round container bytes on the wire
    delta_pages: int = 0         # pages in the frozen final delta

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


# ------------------------------------------------------ state container ----
def encode_snapshot(header: Dict[str, Any], arrays: Any) -> bytes:
    """Pack a tenant snapshot into the safe versioned bitstream container
    (``CYBS`` magic, ``kind="migration"``, npz payload, no pickle)."""
    hdr = {"state_version": MIGRATION_STATE_VERSION, **header}
    return B.encode("migration", hdr, arrays=arrays)


def decode_snapshot(blob: bytes) -> Tuple[Dict[str, Any], Any]:
    """Unpack + validate a migration snapshot.  Bad magic, unknown kind,
    container-version or state-version mismatch all raise
    :class:`BitstreamError` — a snapshot is never half-applied."""
    _, header, arrays = B.decode(blob, expect_kind="migration")
    ver = header.get("state_version")
    if ver != MIGRATION_STATE_VERSION:
        raise BitstreamError(
            f"migration state version {ver!r} does not match this "
            f"runtime ({MIGRATION_STATE_VERSION}); refusing to restore")
    return header, arrays or {}


def encode_snapshot_stream(header: Dict[str, Any], arrays: Any):
    """Chunked form of :func:`encode_snapshot` — yields bounded chunks,
    the payload is never duplicated in host memory."""
    hdr = {"state_version": MIGRATION_STATE_VERSION, **header}
    return B.encode_stream("migration", hdr, arrays=arrays)


def decode_snapshot_stream(chunks) -> Tuple[Dict[str, Any], Any]:
    """Chunked form of :func:`decode_snapshot` (integrity-verified
    incrementally as chunks arrive)."""
    _, header, arrays = B.decode_stream(chunks, expect_kind="migration")
    ver = header.get("state_version")
    if ver != MIGRATION_STATE_VERSION:
        raise BitstreamError(
            f"migration state version {ver!r} does not match this "
            f"runtime ({MIGRATION_STATE_VERSION}); refusing to restore")
    return header, arrays or {}


def save_snapshot(path: str, header: Dict[str, Any], arrays: Any) -> int:
    blob = encode_snapshot(header, arrays)
    Path(path).write_bytes(blob)
    return len(blob)


def load_snapshot(path: str) -> Tuple[Dict[str, Any], Any]:
    return decode_snapshot(Path(path).read_bytes())


# ------------------------------------------------------- snapshot side -----
def snapshot_tenant(shell, slot: int, *,
                    only_pages=None) -> Tuple[Dict[str, Any], Any]:
    """Snapshot the (already quiesced) serving tenant on ``slot``:
    engine paged state + slot port state (CSR file, cThread address map).
    Returns the ``(header, arrays)`` pair :func:`encode_snapshot` packs.
    ``only_pages`` restricts KV payloads to a share-key subset (the
    pre-copy freeze passes the final dirty delta)."""
    engine = shell.engines.get(slot)
    if engine is None:
        raise MigrationError(
            f"no serving engine bound to slot {slot} on this shell "
            "(migratable tenants are paged ServingEngines created with "
            "shell=...)")
    header, arrays = engine.snapshot_state(only_pages=only_pages)
    port = shell.attach(slot)
    psnap = port.snapshot()
    header["tenant"] = shell.vfpgas[slot].tenant
    header["port"] = {
        "csr": {str(reg): int(val)
                for reg, val in psnap.get("csr", {}).items()},
        "next_vaddr": int(psnap.get("next_vaddr", 0)),
        "app": psnap.get("app"),
    }
    addr_map = psnap.get("addr_map") or {}
    if addr_map:
        arrays["addr_map"] = {str(v): np.asarray(buf)
                              for v, buf in addr_map.items()}
    return header, arrays


def _restore_port_state(shell, slot: int, header: Dict[str, Any],
                        arrays: Any) -> None:
    """Apply the snapshotted CSR file and cThread address map to the
    destination slot (getMem buffers outlive the logic they feed)."""
    vf = shell.vfpgas[slot]
    pstate = header.get("port", {})
    for reg, val in pstate.get("csr", {}).items():
        vf.iface.csr.set_csr(int(val), int(reg))
    for vaddr, buf in (arrays.get("addr_map") or {}).items():
        vf._addr_map[int(vaddr)] = np.asarray(buf)
    nv = int(pstate.get("next_vaddr", 0))
    vf._next_vaddr = max(vf._next_vaddr, nv)


def _record_migration_fault(shell, exc: BaseException, *, slot: int,
                            tenant: Optional[str], stage: str) -> None:
    """Account a failed migration stage in the source shell's health
    ledger (the source keeps serving; the fault is informational)."""
    health = getattr(shell, "health", None)
    if health is not None:
        health.record_fault(
            getattr(exc, "kind", FaultKind.MIGRATION_FAIL), slot=slot,
            tenant=tenant, site=f"migrate.{stage}", strike=False,
            msg=str(exc))


# ------------------------------------------------------------ pipeline -----
def _resolve_slot(shell, target: Union[int, str]) -> int:
    if isinstance(target, int):
        return target
    for slot, eng in shell.engines.items():
        if eng.tenant == target:
            return slot
    for vf in shell.vfpgas:
        if vf.tenant == target and vf.slot in shell.engines:
            return vf.slot
    tenants = sorted({e.tenant for e in shell.engines.values()
                      if e.tenant is not None})
    raise MigrationError(
        f"no migratable tenant {target!r} on this shell "
        f"(tenants: {tenants})")


def _resolve_pair(src_shell, dst_shell, target: Union[int, str],
                  dst_slot: Optional[int]):
    """Resolve and validate a (source engine, destination engine) pair
    for a move: both slots must host engines with matching geometry."""
    slot = _resolve_slot(src_shell, target)
    engine = src_shell.engines.get(slot)
    if engine is None:
        raise MigrationError(
            f"no serving engine bound to source slot {slot}")
    dslot = slot if dst_slot is None else dst_slot
    dst_engine = dst_shell.engines.get(dslot)
    if dst_engine is None:
        raise MigrationError(
            f"no serving engine bound to destination slot {dslot} — "
            "load the app and create its engine before migrating onto it")
    if dst_engine.geometry() != engine.geometry():
        raise MigrationError(
            f"geometry mismatch: source {engine.geometry()} vs "
            f"destination {dst_engine.geometry()}")
    tenant = engine.tenant or src_shell.vfpgas[slot].tenant
    return slot, engine, dslot, dst_engine, tenant


def migrate(src_shell, dst_shell, target: Union[int, str], *,
            dst_slot: Optional[int] = None,
            drain_timeout: float = 30.0) -> MigrationReport:
    """Move a live paged serving tenant from ``src_shell`` to
    ``dst_shell`` with zero lost and zero duplicated completions.

    ``target`` is a vFPGA slot index or a tenant name on the source
    shell; ``dst_slot`` defaults to the same index.  The destination
    slot must already host a :class:`~repro_torch.serve.engine.ServingEngine`
    with matching geometry (same model shape, page size, KV layout) and
    identical weights — migration moves *state*, the logic is loaded by
    the normal app-bitstream path.  On any failure the source port
    resumes and the tenant keeps serving where it was.

    Call between engine steps (a decode step is the atomic unit, exactly
    like the executor lanes' checkpoint boundaries): the port quiesce
    holds *port* traffic, and the snapshot assumes no ``step()`` is
    concurrently writing the pools.
    """
    slot, engine, dslot, dst_engine, tenant = _resolve_pair(
        src_shell, dst_shell, target, dst_slot)
    src_port = src_shell.attach(slot)

    t0 = time.perf_counter()
    # -- 1. quiesce ---------------------------------------------------------
    # every drain result is checked: a snapshot taken while tenant work
    # is still in flight would be torn (CSR/addr-map mutating under it)
    if not src_port.quiesce(timeout=drain_timeout):
        src_port.resume()
        raise MigrationError(
            f"slot {slot} failed to quiesce within {drain_timeout}s "
            f"({src_port.inflight()} invocations in flight); migration "
            "aborted, intake resumed")
    if tenant is not None and not src_shell.scheduler.drain_tenant(
            tenant, timeout=drain_timeout):
        src_port.resume()
        raise MigrationError(
            f"tenant {tenant!r} still has link traffic in flight after "
            f"{drain_timeout}s; migration aborted, intake resumed")
    if not engine.flush_io(timeout=drain_timeout):
        src_port.resume()
        raise MigrationError(
            f"engine decode-IO futures did not drain within "
            f"{drain_timeout}s; migration aborted, intake resumed")
    t_q = time.perf_counter()

    # -- 2. snapshot (device KV gather + container round-trip) --------------
    try:
        maybe_fire(getattr(src_shell, "faults", None), "migrate.snapshot",
                   slot=slot, tenant=tenant)
        header, arrays = snapshot_tenant(src_shell, slot)
        blob = encode_snapshot(header, arrays)
    except BaseException as e:
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="snapshot")
        src_port.resume()
        raise
    t_s = time.perf_counter()

    # -- 3. restore on the destination --------------------------------------
    # the destination slot's QoS binding moves only now, after the source
    # snapshot is in hand — an aborted quiesce never touches the dst
    prev_tenant = dst_shell.vfpgas[dslot].tenant
    dst_port = dst_shell.attach(dslot, tenant=tenant)
    try:
        maybe_fire(getattr(src_shell, "faults", None), "migrate.restore",
                   slot=slot, tenant=tenant)
        rheader, rarrays = decode_snapshot(blob)
        stats = dst_engine.restore_state(rheader, rarrays)
        _restore_port_state(dst_shell, dslot, rheader, rarrays)
    except Exception as e:  # noqa: BLE001 — ANY restore failure (bad
        # container, geometry/capacity refusal, id collision) must leave
        # the source serving; nothing was freed there yet
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="restore")
        if prev_tenant is not None and prev_tenant != tenant:
            dst_shell.attach(dslot, tenant=prev_tenant)   # rebind back
        src_port.resume()
        raise MigrationError(f"restore failed on destination: {e}") from e
    t_r = time.perf_counter()

    # -- 4. evacuate the source, replay held work on the destination --------
    replayed = _evacuate_and_replay(src_shell, engine, src_port, dst_port,
                                    slot=slot, tenant=tenant)
    t_done = time.perf_counter()

    return MigrationReport(
        tenant=tenant, src_slot=slot, dst_slot=dslot,
        n_requests=stats["requests"], n_queued=stats["queued"],
        n_pages=stats["pages"], payload_bytes=len(blob),
        replayed=replayed,
        quiesce_s=t_q - t0, snapshot_s=t_s - t_q,
        restore_s=t_r - t_s, replay_s=t_done - t_r,
        downtime_s=t_done - t0)


def _evacuate_and_replay(src_shell, engine, src_port, dst_port, *,
                         slot: int, tenant: Optional[str]) -> int:
    """Final migration stage, shared by stop-and-copy and pre-copy:
    evacuate the source engine and replay held invocations on the
    destination port — exactly once each, whatever fails."""
    engine.evacuate()
    pending = list(src_port.take_held())
    replayed = 0
    try:
        maybe_fire(getattr(src_shell, "faults", None), "migrate.replay",
                   slot=slot, tenant=tenant)
        # one at a time, so a mid-list failure knows EXACTLY which
        # invocations the destination consumed (dispatched or joined its
        # held FIFO) and which it never touched
        while pending:
            replayed += dst_port.replay_adopted(pending[:1])
            pending.pop(0)
    except Exception as e:  # noqa: BLE001 — e.g. the destination port
        # was closed by a racing cold_restart.  The tenant's state HAS
        # moved, but no held future may be dropped OR duplicated: only
        # the invocations the destination never touched re-hold at the
        # source (re-ticketed) and replay there on resume — exactly
        # once either way, nothing wedged QUIESCED.
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="replay")
        src_port.restore_held(pending)
        src_port.resume()
        raise MigrationError(
            f"replay on destination port failed after restore: {e}; "
            f"{len(pending)} untouched invocation(s) replayed at the "
            "source, which no longer holds the tenant's paged state"
        ) from e
    src_port.resume()                     # slot reusable, nothing held
    return replayed


# ----------------------------------------------------- pre-copy pipeline ----
def _key_str(key: Tuple) -> str:
    """JSON-safe spelling of an MMU share key: ("d", 3) -> "d:3"."""
    return ":".join(str(x) for x in key)


def _gather_page_payloads(engine, keys) -> Dict[Tuple, Dict[str, Any]]:
    """Gather KV payloads for a set of MMU share keys: one batched
    device gather for the ("d", ppage) keys (``engine.gather_kv``, as
    the full snapshot: every KV head, also from a tensor-parallel
    source) plus the preserved host payloads for ("h", hslot) keys.
    Keys with no materialized bytes ("u" legacy pages, host slots
    evicted without a pager) are skipped — exactly what a full snapshot
    would skip."""
    from repro_torch.serve.paged_model import flat_page_indices
    mmu = engine.mmu
    out: Dict[Tuple, Dict[str, Any]] = {}
    dpages = sorted(k[1] for k in keys if k[0] == "d")
    if dpages:
        flat = flat_page_indices(dpages, engine.cfg.n_layers,
                                 mmu.config.n_pages)
        kv = engine.gather_kv(flat)   # every KV head, also under TP
        L = engine.cfg.n_layers
        kk = kv["k"].reshape(L, len(dpages), *kv["k"].shape[1:])
        vv = kv["v"].reshape(L, len(dpages), *kv["v"].shape[1:])
        for i, pp in enumerate(dpages):
            out[("d", pp)] = weights_to_host(
                {"k": kk[:, i].contiguous(), "v": vv[:, i].contiguous()})
    for k in keys:
        if k[0] == "h":
            data = mmu.host_payload(k[1])
            if data is not None:
                out[k] = weights_to_host({"k": data["k"], "v": data["v"]})
    return out


def migrate_precopy(src_shell, dst_shell, target: Union[int, str], *,
                    dst_slot: Optional[int] = None,
                    drain_timeout: float = 30.0,
                    max_rounds: int = 6, dirty_floor: int = 1,
                    decode_between_rounds: int = 1) -> MigrationReport:
    """Pre-copy live migration: O(dirty delta) downtime.

    Warm rounds run with the source port fully open: each round ships
    the pages that are new or were dirtied since the previous round
    (``MMU.dirty_snapshot``) through the chunked container stream into
    pages *reserved* on the destination MMU, then lets the source decode
    ``decode_between_rounds`` steps.  Rounds stop when the dirty set
    converges to ``dirty_floor`` pages (or ``max_rounds`` hits — a write
    rate above the copy rate can never converge; the freeze bounds it).
    The freeze then quiesces exactly like :func:`migrate` but snapshots
    only the final dirty delta; ``restore_state(staged=...)`` makes the
    destination adopt the pre-staged pages, the delta overwrites the few
    that changed, and held invocations replay.  Downtime covers the
    freeze only.

    Failure containment: a warm-round failure (including an injected
    ``"migrate.precopy"`` fault) releases every staged page and raises —
    the source was never paused.  Freeze-phase failures release the
    staging (unless the destination already adopted it) and resume the
    source, exactly like stop-and-copy.
    """
    slot, engine, dslot, dst_engine, tenant = _resolve_pair(
        src_shell, dst_shell, target, dst_slot)
    mmu, dst_mmu = engine.mmu, dst_engine.mmu
    faults = getattr(src_shell, "faults", None)
    src_port = src_shell.attach(slot)

    # -- warm rounds: source keeps serving ----------------------------------
    staged: Dict[Tuple, int] = {}
    rounds = precopy_pages = precopy_bytes = 0
    try:
        while rounds < max_rounds:
            # PEEK the dirty set first: if we break here, unshipped
            # dirty flags must survive into the freeze's final delta
            dirty = mmu.dirty_snapshot()
            live = mmu.live_page_keys()
            to_ship = (live - staged.keys()) | (dirty & live)
            if not to_ship or (rounds > 0
                               and len(to_ship) <= dirty_floor):
                break
            maybe_fire(faults, "migrate.precopy", slot=slot,
                       tenant=tenant)
            mmu.clear_dirty()
            payloads = _gather_page_payloads(engine, to_ship)
            chunks = list(B.encode_stream(
                "migration",
                {"state_version": MIGRATION_STATE_VERSION,
                 "precopy_round": rounds},
                arrays={"pages": {_key_str(k): v
                                  for k, v in payloads.items()}}))
            precopy_bytes += sum(len(c) for c in chunks)
            _, _, rarr = B.decode_stream(chunks,
                                         expect_kind="migration")
            new_keys = sorted(k for k in payloads if k not in staged)
            if new_keys:
                staged.update(zip(new_keys,
                                  dst_mmu.reserve_pages(len(new_keys))))
            for k in sorted(payloads):
                dst_engine._pager_scatter(staged[k],
                                          rarr["pages"][_key_str(k)])
            precopy_pages += len(payloads)
            rounds += 1
            for _ in range(decode_between_rounds):
                engine.step()             # the source keeps decoding
    except BaseException as e:
        if staged:
            dst_mmu.release_pages(list(staged.values()))
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="precopy")
        raise MigrationError(
            f"pre-copy warm phase failed: {e}; the source was never "
            "paused and keeps serving") from e

    def _abort_freeze(msg: str) -> MigrationError:
        if staged:
            dst_mmu.release_pages(list(staged.values()))
        src_port.resume()
        return MigrationError(msg)

    t0 = time.perf_counter()
    # -- freeze: quiesce (same checks as migrate()) -------------------------
    if not src_port.quiesce(timeout=drain_timeout):
        raise _abort_freeze(
            f"slot {slot} failed to quiesce within {drain_timeout}s "
            f"({src_port.inflight()} invocations in flight); migration "
            "aborted, intake resumed")
    if tenant is not None and not src_shell.scheduler.drain_tenant(
            tenant, timeout=drain_timeout):
        raise _abort_freeze(
            f"tenant {tenant!r} still has link traffic in flight after "
            f"{drain_timeout}s; migration aborted, intake resumed")
    if not engine.flush_io(timeout=drain_timeout):
        raise _abort_freeze(
            f"engine decode-IO futures did not drain within "
            f"{drain_timeout}s; migration aborted, intake resumed")
    t_q = time.perf_counter()

    # -- final delta snapshot: O(pages dirtied since the last round) --------
    try:
        maybe_fire(faults, "migrate.snapshot", slot=slot, tenant=tenant)
        final_dirty = mmu.dirty_snapshot()
        live = mmu.live_page_keys()
        delta = (live - staged.keys()) | (final_dirty & live)
        header, arrays = snapshot_tenant(src_shell, slot,
                                         only_pages=delta)
        chunks = list(encode_snapshot_stream(header, arrays))
        payload_bytes = sum(len(c) for c in chunks)
    except BaseException as e:
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="snapshot")
        if staged:
            dst_mmu.release_pages(list(staged.values()))
        src_port.resume()
        raise
    t_s = time.perf_counter()

    # -- restore: adopt staged pages, overwrite the delta -------------------
    snap_sids = [int(sd["seq_id"]) for sd in header["mmu"]["seqs"]]
    prev_tenant = dst_shell.vfpgas[dslot].tenant
    dst_port = dst_shell.attach(dslot, tenant=tenant)
    try:
        maybe_fire(faults, "migrate.restore", slot=slot, tenant=tenant)
        rheader, rarrays = decode_snapshot_stream(chunks)
        stats = dst_engine.restore_state(rheader, rarrays,
                                         staged=dict(staged))
        _restore_port_state(dst_shell, dslot, rheader, rarrays)
    except Exception as e:  # noqa: BLE001 — same containment as
        # migrate(); additionally the staging is released UNLESS the
        # destination MMU already adopted it into live sequences (then
        # the pages belong to those mappings, not the reservation)
        _record_migration_fault(src_shell, e, slot=slot, tenant=tenant,
                                stage="restore")
        if staged and not dst_mmu.live_page_keys(snap_sids):
            dst_mmu.release_pages(list(staged.values()))
        if prev_tenant is not None and prev_tenant != tenant:
            dst_shell.attach(dslot, tenant=prev_tenant)   # rebind back
        src_port.resume()
        raise MigrationError(f"restore failed on destination: {e}") from e
    # staged pages the final snapshot no longer references (their page
    # was freed or evicted at the source between warm round and freeze)
    # go back to the free pool — adopted ones are owned by sequences now
    used = set()
    for sd in rheader["mmu"]["seqs"]:
        for p in sd["pages"]:
            used.add(_share_key(int(sd["seq_id"]), p))
    stale = [pp for k, pp in staged.items() if k not in used]
    if stale:
        dst_mmu.release_pages(stale)
    t_r = time.perf_counter()

    # -- evacuate + replay (shared with migrate()) --------------------------
    replayed = _evacuate_and_replay(src_shell, engine, src_port, dst_port,
                                    slot=slot, tenant=tenant)
    t_done = time.perf_counter()

    return MigrationReport(
        tenant=tenant, src_slot=slot, dst_slot=dslot,
        n_requests=stats["requests"], n_queued=stats["queued"],
        n_pages=len(used), payload_bytes=payload_bytes,
        replayed=replayed,
        quiesce_s=t_q - t0, snapshot_s=t_s - t_q,
        restore_s=t_r - t_s, replay_s=t_done - t_r,
        downtime_s=t_done - t0,
        precopy_rounds=rounds, precopy_pages=precopy_pages,
        precopy_bytes=precopy_bytes, delta_pages=len(delta))


# --------------------------------------------------- local slot recovery ----
@dataclass
class RecoveryReport:
    """What one :func:`recover_tenant_local` did and what it cost.
    ``downtime_s`` is intake-hold to held-invocation replay completing —
    the recovered tenant's observed service gap."""
    slot: int
    tenant: Optional[str]
    n_requests: int          # in-flight requests restored
    n_queued: int            # queued requests restored
    n_pages: int             # KV pages preserved across the restart
    payload_bytes: int       # encoded snapshot container size
    failed_inflight: int     # wedged in-flight invocations force-failed
    replayed: int            # held invocations replayed after recovery
    quiesce_s: float
    snapshot_s: float
    restart_s: float
    restore_s: float
    downtime_s: float

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


def recover_tenant_local(shell, slot: int, *,
                         drain_timeout: float = 5.0) -> RecoveryReport:
    """Self-healing restart of ONE slot on ONE shell — the watchdog's
    recovery verb (``Shell.recover_slot`` wraps it).

    The local reuse of the migration container: quiesce the slot's port
    (a wedged in-flight tail that cannot complete is force-failed with
    typed errors, held submissions are kept), snapshot the tenant's
    paged state through the same versioned ``CYBS`` container a
    cross-shell move uses, cold-reset the engine's device soft state
    (fresh block-table view, zeroed decode vectors, TLB flush — the
    "restart"), then restore from the container: fresh page allocation,
    KV payloads (device gather + refcounted host payloads) scattered
    back, decode state and sampling seed re-adopted.  Held invocations replay on
    resume.  Decoding then continues token-for-token where it left off —
    the KV pages survived the restart.
    """
    engine = shell.engines.get(slot)
    if engine is None:
        raise MigrationError(
            f"no serving engine bound to slot {slot}; recover_tenant_local "
            "only heals paged serving tenants (ServingEngine, shell=...)")
    tenant = engine.tenant or shell.vfpgas[slot].tenant
    port = shell.attach(slot)

    t0 = time.perf_counter()
    # -- 1. quiesce; a wedged tail may never complete: force-fail it -------
    failed = 0
    if not port.quiesce(timeout=drain_timeout, resume_on_timeout=False):
        failed = port.fail_inflight()
        if not port.quiesce(timeout=drain_timeout,
                            resume_on_timeout=False):
            port.resume()
            raise MigrationError(
                f"slot {slot} would not quiesce even after force-failing "
                f"{failed} in-flight invocation(s); recovery aborted, "
                "intake resumed")
    if tenant is not None:
        shell.scheduler.drain_tenant(tenant, timeout=drain_timeout)
    engine.flush_io(timeout=drain_timeout)
    t_q = time.perf_counter()

    # -- 2. snapshot through the migration container ------------------------
    try:
        header, arrays = snapshot_tenant(shell, slot)
        blob = encode_snapshot(header, arrays)
    except BaseException as e:
        _record_migration_fault(shell, e, slot=slot, tenant=tenant,
                                stage="snapshot")
        port.resume()
        raise
    t_s = time.perf_counter()

    # -- 3. the "restart": evacuate + cold-reset device soft state ----------
    engine.evacuate()
    engine.reset_decode_state()
    t_restart = time.perf_counter()

    # -- 4. restore from the container, replay held work --------------------
    try:
        rheader, rarrays = decode_snapshot(blob)
        stats = engine.restore_state(rheader, rarrays)
        _restore_port_state(shell, slot, rheader, rarrays)
    except Exception as e:  # noqa: BLE001 — the engine is already reset;
        # resume so held work fails/replays against the empty engine
        # rather than wedging, and surface the loss loudly
        _record_migration_fault(shell, e, slot=slot, tenant=tenant,
                                stage="restore")
        port.resume()
        raise MigrationError(
            f"local restore failed on slot {slot}: {e} (the tenant's "
            "state is intact in the snapshot container, but the live "
            "engine was reset)") from e
    replayed = port.resume()
    t_done = time.perf_counter()

    return RecoveryReport(
        slot=slot, tenant=tenant,
        n_requests=stats["requests"], n_queued=stats["queued"],
        n_pages=stats["pages"], payload_bytes=len(blob),
        failed_inflight=failed, replayed=replayed,
        quiesce_s=t_q - t0, snapshot_s=t_s - t_q,
        restart_s=t_restart - t_s, restore_s=t_done - t_restart,
        downtime_s=t_done - t0)
