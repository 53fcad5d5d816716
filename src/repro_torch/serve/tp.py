"""Tensor-parallel paged serving on ``torch.distributed``.

Twin of ``repro.serve.tp``.  One serving tenant spans every rank of a
mesh's ``model`` dim while the shell stays logically single — the Coyote
v2 move of making placement a property of the shell, not the app.

The reference drives every device of the mesh from one process
(``shard_map`` + ``jit``).  ``torch.distributed`` runs one process per
rank, so here every rank runs the same engine on the same submits: the
host state (MMU, block table, prefix index, pager, queue, scheduler,
shell) is replicated, the same on each rank, and only the tensors are
split:

  * **Weights** are Megatron-style tensor-parallel
    (``MeshRules.serving()``: TP columns, no FSDP rows): ``wq/wk/wv``
    (and ``bq/bk/bv``) split by columns on the flattened head dim — whole
    heads, since the columns are ``(n_heads, head_dim)`` flattened —
    ``wo`` by rows; SwiGLU ``w_gate/w_up`` by columns on ``d_ff``,
    ``w_down`` by rows.  Embeddings, norms, lm_head and MoE experts stay
    replicated.  :attr:`TPContext.params` holds this rank's local tensors.
  * **KV pools** hold every page but only this rank's KV heads, so paged
    attention (the CUDA kernel, on the rank's head slice) needs no
    collective and the page-id geometry — block tables, pager, migration
    wire format — is untouched.
  * **Reductions** go through :meth:`CollectiveService.all_reduce`
    (``axes=("model",)``): one after the attention out-projection and one
    after the FFN per layer.  Everything between blocks is replicated.
  * **Sampling** runs on replicated logits with the same seed on every
    rank; the engine then broadcasts model-rank 0's (B,) token vector so
    that no last-ulp difference can split the ranks' host state.

Degradation is static and per-part: heads shard only when BOTH
``n_heads`` and ``n_kv_heads`` divide the TP degree, the FFN only for
non-MoE SwiGLU with divisible ``d_ff``.  A part that cannot shard is
replicated and its reduction hook is ``None`` — never applied to an
already-complete sum.

**The gateway's front end.**  A :class:`~repro_torch.serve.gateway.
ServingGateway`'s admission hook (its ``_backfill``) reads the rank's own
clock to expire queued requests, age their priorities and order them by
slack, so the ranks would decide differently and deadlock.
:meth:`TPContext.backfill` runs it on model-rank 0 alone and broadcasts
the outcome over the ``model`` group as one ``(Q, 3)`` int32 tensor, a
row ``(gid, disposition, effective priority)`` for each of the ``Q``
queued requests: the expired ones in queue order, the dispatched ones in
the order rank 0 submitted them, then the rest of the queue in rank 0's
new order.  The other ranks replay it on their own gateways (the same
typed ``SLO_EXPIRED`` refusals, ``engine.submit`` calls and queue) and
never call the hook.  Should rank 0's backfill raise, the broadcast still
goes out, so that no rank waits on it: a raising ``engine.submit`` (a
prompt token out of the vocabulary, a quarantined tenant) is marked on
its row, and the other ranks leave their gateways as rank 0's was left
and make the same call, which raises the same typed error; anything else
marks every row, and the other ranks raise a ``RuntimeError``.  The rest
of the gateway is rank-consistent as it stands: ``submit``'s SLO check
compares a service estimate from the EWMAs, which are rank 0's, with a
relative deadline, and the queue bound and the engine's occupancy are
replicated host state.  Any other
admission hook runs on every rank, so it must decide from replicated
state alone.

Every collective is issued from the engine's calling thread, in program
order, on every rank of the group.
"""
from __future__ import annotations

import functools
import math
from dataclasses import replace
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.core.faults import FaultKind
from repro_torch.core.port import PortError
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.models.sharding import MeshRules, P, local_shard
from repro_torch.serve import paged_model
from repro_torch.serve.gateway import ServingGateway

# a queued gateway request's disposition in the front end's outcome; the
# last two only when model-rank 0's backfill raised
EXPIRED, DISPATCHED, QUEUED, FAILED, RAISED = 0, 1, 2, 3, -1


def tp_plan(cfg: ModelConfig, tp_size: int) -> Dict[str, bool]:
    """Static sharding decisions for a config at a TP degree.

    ``shard_heads``: attention weights + KV pools split on the head dim —
    requires whole query AND kv heads per shard (GQA groups must not
    straddle ranks).  ``shard_mlp``: SwiGLU hidden dim split — MoE FFNs
    and GELU MLPs (whose ``b_down`` bias is added before the reduction)
    stay replicated.
    """
    shard_heads = (tp_size > 1
                   and cfg.n_heads % tp_size == 0
                   and cfg.n_kv_heads % tp_size == 0)
    shard_mlp = (tp_size > 1 and cfg.moe is None and cfg.act == "silu"
                 and cfg.d_ff % tp_size == 0)
    return {"shard_heads": shard_heads, "shard_mlp": shard_mlp}


class TPContext:
    """Mesh-bound tensor-parallel twins of the paged serving functions.

    Construct once per (engine, mesh) on every rank; exposes this rank's
    parameters (``.params``), the local config (``.local_cfg``), the KV
    spec, and ``decode_step`` / ``prefill_shared`` / ``prefill_chunk`` /
    ``prefill_paged`` with the single-device functions' signatures (local
    config and reduction hooks pre-bound).
    """

    def __init__(self, cfg: ModelConfig, mesh, params, *, page_size: int,
                 collectives: Optional[CollectiveService] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = MeshRules.from_mesh(mesh).serving()
        self.axis = self.rules.tp_axis
        self.tp_size = self.rules.tp_size or 1
        self.rank = mesh.get_local_rank(self.axis)
        self.collectives = (collectives if collectives is not None
                            else CollectiveService())
        plan = tp_plan(cfg, self.tp_size)
        self.shard_heads = plan["shard_heads"]
        self.shard_mlp = plan["shard_mlp"]
        # Per-rank view of the model: LOCAL head counts.  head_dim is
        # pinned because resolved_head_dim would otherwise re-derive it
        # from the reduced n_heads (d_model // local_heads is wrong by a
        # factor of tp).
        if self.shard_heads:
            self.local_cfg = replace(
                cfg, n_heads=cfg.n_heads // self.tp_size,
                n_kv_heads=cfg.n_kv_heads // self.tp_size,
                head_dim=cfg.resolved_head_dim)
        else:
            self.local_cfg = cfg
        self.kv_spec = (P(None, None, self.axis, None) if self.shard_heads
                        else P())
        self._pspecs = self._param_specs(params)
        self.params = pytree.tree_map(
            lambda x, s: local_shard(x, mesh, s), params, self._pspecs,
            is_leaf=lambda x: isinstance(x, P))
        hooks = dict(psum_attn=self._reduce if self.shard_heads else None,
                     psum_mlp=self._reduce if self.shard_mlp else None)
        self.hooks = hooks
        common = dict(cfg=self.local_cfg, page_size=page_size, **hooks)
        self.decode_step = functools.partial(paged_model.decode_step_paged,
                                             **common)
        self.prefill_shared = functools.partial(
            paged_model.prefill_shared_paged, **common)
        self.prefill_chunk = functools.partial(
            paged_model.prefill_chunk_paged, **common)

    def prefill_paged(self, params, pools, tokens, lens, tables, seed,
                      temperatures, top_k=None, top_p=None, seq_ids=None, *,
                      filters_on: Optional[bool] = None):
        """TP twin of :func:`repro_torch.serve.paged_model.prefill_paged`,
        routed through the shared-prefix prefill with zero coverage
        (``q_starts = write_from = 0``), as the reference's twin is: the
        dense forward has no reduction sites."""
        zeros = torch.zeros_like(lens)
        return self.prefill_shared(params, pools, tokens, lens, zeros, zeros,
                                   tables, seed, temperatures, top_k, top_p,
                                   seq_ids, filters_on=filters_on)

    # ------------------------------------------------------------ specs ----
    def _param_specs(self, params):
        """Spec tree congruent with the serving param tree: replicated
        everywhere except the TP-split attention/FFN matrices (the stacked
        layer axis — index 0 — is never split)."""
        specs = pytree.tree_map(lambda _: P(), params)
        ax = self.axis
        if self.shard_heads:
            a = specs["layers"]["attn"]
            a["wq"] = P(None, None, ax)
            a["wk"] = P(None, None, ax)
            a["wv"] = P(None, None, ax)
            a["wo"] = P(None, ax, None)
            for b in ("bq", "bk", "bv"):
                if b in a:
                    a[b] = P(None, ax)
        if self.shard_mlp:
            f = specs["layers"]["ffn"]
            f["w_gate"] = P(None, None, ax)
            f["w_up"] = P(None, None, ax)
            f["w_down"] = P(None, ax, None)
        return specs

    def _reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum TP partials through the collective service port."""
        return self.collectives.all_reduce(x, self.mesh, axes=(self.axis,))

    # ----------------------------------------------------------- helpers ----
    def head_slice(self) -> slice:
        """This rank's KV heads in the full head axis."""
        k = self.local_cfg.n_kv_heads
        return (slice(self.rank * k, (self.rank + 1) * k)
                if self.shard_heads else slice(None))

    def gather_heads(self, kv: torch.Tensor) -> torch.Tensor:
        """Every rank's KV heads of a (n, page, K_local, hd) page gather,
        concatenated on the head axis: the full-head copy the host keeps
        (the pager, migration)."""
        if not self.shard_heads:
            return kv
        return self.collectives.all_gather(kv, self.mesh, self.axis, dim=2)

    def local_heads(self, kv: torch.Tensor) -> torch.Tensor:
        """This rank's heads of a full-head page payload."""
        return kv[:, :, self.head_slice()]

    def broadcast_from_rank0(self, x: torch.Tensor) -> torch.Tensor:
        """Model-rank 0's ``x`` on every rank of the group (in place)."""
        return self.collectives.broadcast(x, self.mesh, self.axis, src=0)

    # ------------------------------------------------ the gateway's hook ----
    @staticmethod
    def gateway_of(hook) -> Optional[ServingGateway]:
        """The gateway whose backfill ``hook`` is, else None."""
        gw = getattr(hook, "__self__", None)
        if isinstance(gw, ServingGateway) and hook.__name__ == "_backfill":
            return gw
        return None

    def backfill(self, engine, gateway: ServingGateway) -> None:
        """The gateway's admission hook, decided on model-rank 0 and
        replayed on the other ranks (module docstring).  One broadcast of
        ``(Q, 3)`` int32; none when the queue, whose length every rank
        sees, is empty.  When rank 0's backfill raises, the broadcast
        still goes out and every rank raises after it."""
        q = len(gateway.queue)
        if q == 0:
            return
        if len({p.stream.gid for p in gateway.queue}) != q:
            # streams adopted from another gateway may repeat a gid; every
            # rank sees it, so all refuse before the broadcast
            raise RuntimeError("the gateway's queue repeats a gid, which "
                               "the ranks cannot agree on")
        error = None
        if self.rank == 0:
            rows, error = _backfill_outcome(engine, gateway)
            buf = torch.from_numpy(rows).to(engine.device)
        else:
            buf = torch.empty((q, 3), dtype=torch.int32,
                              device=engine.device)
        self.broadcast_from_rank0(buf)
        if error is not None:
            raise error
        if self.rank != 0:
            _replay_backfill(engine, gateway, buf.cpu().numpy())

    def allreduce_bytes_per_step(self, batch: int) -> int:
        """Modeled GLOBAL payload bytes all-reduced per decode step: one
        fp32 (B, 1, d_model) activation per enabled reduction site per
        layer.  Feed to :meth:`CollectiveService.wire_bytes` for the
        per-rank wire estimate."""
        sites = int(self.shard_heads) + int(self.shard_mlp)
        return sites * self.cfg.n_layers * batch * self.cfg.d_model * 4


class _SubmitWatch:
    """The engine as the gateway's backfill sees it on model-rank 0,
    noting whether one of its ``submit`` calls raised."""

    def __init__(self, engine):
        self._engine = engine
        self.raised = False

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def submit(self, *args, **kwargs):
        try:
            return self._engine.submit(*args, **kwargs)
        except Exception:
            self.raised = True
            raise


def _backfill_outcome(engine, gw: ServingGateway):
    """Run ``gw``'s backfill and encode what it did to its queue as
    ``(gid, disposition, eff_priority)`` rows: expired in queue order,
    dispatched in submit order (the engine's rids rise), then the queue
    that is left, in its new order.  Returns the rows and the exception
    the backfill raised, or None.

    When an ``engine.submit`` raised (a prompt token out of the
    vocabulary, a quarantined tenant), its request's row is ``FAILED``
    and comes first in the queue that is left: the backfill stopped
    there, with the dispatched requests still at the front of its queue.
    When anything else raised, or the rows do not account for the queue,
    every row is ``RAISED``."""
    queued = list(gw.queue)
    rid_before = {p.stream.gid: p.stream.rid for p in queued}
    n_rejected = len(gw.rejected)
    watch = _SubmitWatch(engine)
    error = None
    try:
        gw._backfill(watch)
    except Exception as e:
        error = e
    expired = gw.rejected[n_rejected:]
    dispatched = sorted((p.stream for p in queued
                         if p.stream.rid != rid_before[p.stream.gid]),
                        key=lambda s: s.rid)
    sent = {s.gid for s in dispatched}
    left = [p.stream for p in gw.queue if p.stream.gid not in sent]
    rows = ([(s.gid, EXPIRED, s.eff_priority) for s in expired]
            + [(s.gid, DISPATCHED, s.eff_priority) for s in dispatched]
            + [(s.gid, QUEUED, s.eff_priority) for s in left])
    whole = len(rows) == len(queued)
    if error is not None and watch.raised and left and whole:
        rows[len(expired) + len(dispatched)] = (left[0].gid, FAILED,
                                                left[0].eff_priority)
    elif error is not None or not whole:
        if error is None:
            error = RuntimeError(
                f"the gateway's backfill accounted for {len(rows)} of the "
                f"{len(queued)} requests it found queued")
        rows = [(-1, RAISED, 0)] * len(queued)
    return np.asarray(rows, np.int32).reshape(-1, 3), error


def _submit(engine, p) -> int:
    """``engine.submit`` of the queued ``p`` with the arguments that the
    dispatch loop of ``gateway.py::_backfill`` passes."""
    return engine.submit(
        p.prompt, p.stream.max_new_tokens,
        temperature=p.temperature, top_k=p.top_k, top_p=p.top_p,
        tid=p.stream.tid, priority=p.stream.eff_priority,
        deadline_s=(None if math.isinf(p.stream.deadline)
                    else p.stream.deadline))


def _replay_backfill(engine, gw: ServingGateway, rows: np.ndarray) -> None:
    """Apply model-rank 0's backfill outcome to this rank's gateway: the
    refusals, counters, ``engine.submit`` calls and queue order
    ``ServingGateway._backfill`` would have produced on rank 0's clock.

    Mirrors ``gateway.py::_backfill`` (lines 240-294, the same text as
    the reference's ``src/repro/serve/gateway.py``): an expired row is
    its expiry branch (the ``PortError``, ``expired`` and ``rejected``),
    a dispatched row its dispatch loop (``engine.submit``, ``stream.rid``,
    ``streams`` and ``dispatched``), and the queue is what its sort and
    ``del self.queue[:n]`` leave.  A ``FAILED`` row is rank 0's raising
    submit: this rank leaves its queue as rank 0's was left and makes the
    same call, which raises the same error from the same replicated
    state."""
    if len(rows) and rows[0, 1] == RAISED:
        raise RuntimeError("model-rank 0's gateway backfill raised "
                           "(its error is raised on model-rank 0)")
    by_gid = {p.stream.gid: p for p in gw.queue}
    sent, queue, failed = [], [], None
    for gid, disposition, eff_priority in rows.tolist():
        if gid not in by_gid:
            raise RuntimeError(
                f"model-rank 0's gateway queue holds gid {gid}, this "
                "rank's does not: the ranks' gateway submits differ")
        p = by_gid[gid]
        stream = p.stream
        stream.eff_priority = eff_priority
        if disposition == EXPIRED:
            gw.expired += 1
            stream.error = PortError(
                "deadline expired while queued",
                kind=FaultKind.SLO_EXPIRED, slot=engine.slot,
                tenant=engine.tenant, retryable=False)
            gw.rejected.append(stream)
        elif disposition == DISPATCHED:
            stream.rid = _submit(engine, p)
            gw.streams[stream.rid] = stream
            gw.dispatched += 1
            sent.append(p)
        else:
            if disposition == FAILED:
                failed = p
            queue.append(p)
    if failed is None:
        gw.queue = queue
        return
    gw.queue = sent + queue
    _submit(engine, failed)
    raise RuntimeError(
        "model-rank 0's gateway failed to submit a request that this "
        "rank's engine accepted: the ranks' engines differ")
