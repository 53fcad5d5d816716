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

Every collective is issued from the engine's calling thread, in program
order, on every rank of the group.
"""
from __future__ import annotations

import functools
from dataclasses import replace
from typing import Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.models.sharding import MeshRules, P, local_shard
from repro_torch.serve import paged_model


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

    def allreduce_bytes_per_step(self, batch: int) -> int:
        """Modeled GLOBAL payload bytes all-reduced per decode step: one
        fp32 (B, 1, d_model) activation per enabled reduction site per
        layer.  Feed to :meth:`CollectiveService.wire_bytes` for the
        per-rank wire estimate."""
        sites = int(self.shard_heads) + int(self.shard_mlp)
        return sites * self.cfg.n_layers * batch * self.cfg.d_model * 4
