"""Trainer: fault-tolerant, straggler-mitigating training loop.

Twin of ``repro.train.loop``, on one device or on a mesh:

  * checkpoint/restart — async checkpoints every ``ckpt_every``; on
    (injected) failure the loop restores the latest checkpoint and
    continues bit-identically (the data pipeline is pure in step);
  * restore into a new process — checkpoints hold whole host arrays, so
    ``Trainer.restore`` loads them into whatever device this trainer owns;
  * straggler mitigation — the prefetcher feeds through a timeout; a
    straggling host's batch is skipped (logged) instead of stalling the
    step;
  * gradient compression — optional GradCompression service (int8 + error
    feedback, the residuals kept in the optimizer state as ``"ef"`` and
    checkpointed with it);
  * activation recomputation — ``remat`` ("none", "full", "dots") per
    layer body (``models/transformer.py::_remat``).

A step is ``loss_fn`` -> ``torch.autograd.grad`` -> (compression) ->
``adamw.update``, the update in place under ``torch.no_grad()``.  An
encoder-decoder model's batches carry frames.  Every family the
reference's Trainer takes trains here: dense, MoE (its aux loss in the
loss), mamba2 and the zamba2 hybrid (whose ``slots`` tuple the optimizer
and the checkpoint carry as ``slots/<i>/...``).  On the card every
attention forward and backward runs the flash-attention kernels, and every
mamba layer's scan the SSD kernels, forward and backward.

``Trainer(mesh=...)`` (every rank of the mesh builds one, with the same
arguments) steps through ``launch.steps.make_train_bundle``, as the
reference's does: each rank keeps its shards of the parameters, of
AdamW's moments and of compression's residuals, and takes its
``rules.batch`` rows of the same global corpus batch, so the mesh step
sees the single-device step's data.  ``TrainConfig.microbatches``
accumulates gradients under a mesh; without one it is accepted and
ignored, as the reference's mesh-less step ignores it.  A checkpoint
holds whole host arrays (the reference's ``device_get``): every rank
joins the gathers, and only the rank at coordinate 0 of every mesh dim
writes into the shared ``ckpt_dir``; every rank restores the whole
arrays and keeps its shards.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.faults import FaultKind, InjectedFault, maybe_fire
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.data.pipeline import (DataConfig, Prefetcher, SyntheticCorpus,
                                       to_device)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.sharding import (MeshRules, P, flatten_specs,
                                         local_shard, reshard)
from repro_torch.optim import adamw
from repro_torch.telemetry import spans


class SimulatedFailure(InjectedFault):
    """Injected whole-node failure — the trainer's member of the ONE
    shared fault taxonomy (``FaultKind.NODE_FAILURE``, site
    ``train.step``).  Message-positional construction is preserved for
    existing callers; the richer plans arm the same kind through
    ``TrainConfig.fault_plan`` instead."""

    def __init__(self, message: str = "", **kw: Any):
        kw.setdefault("kind", FaultKind.NODE_FAILURE)
        kw.setdefault("site", "train.step")
        kw.setdefault("retryable", False)
        super().__init__(message, **kw)


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "coyote_ckpt")


@dataclass
class TrainConfig:
    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 3
    microbatches: int = 1
    remat: str = "none"
    compute_dtype: Any = None
    param_dtype: Any = torch.float32
    seed: int = 0
    batch_timeout_s: float = 5.0      # straggler skip threshold
    fail_at_step: int = -1            # inject a failure once at this step
    # richer injection: a seeded repro_torch.core.faults.FaultPlan probed
    # once per step at site "train.step" (``fail_at_step`` is sugar for one
    # NODE_FAILURE at a fixed step)
    fault_plan: Any = None
    straggler_steps: tuple = ()       # steps whose host batch is slow
    straggler_delay_s: float = 0.0
    compression: Any = None           # GradCompression service or None
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


class Trainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainConfig, mesh=None, *, device=None):
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.mesh = mesh
        self.rules = (MeshRules.from_mesh(mesh) if mesh is not None
                      else MeshRules.single_device())
        self.collectives = CollectiveService()
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.metrics_log: List[Dict[str, float]] = []
        self.skipped_steps: List[int] = []
        self._build()

    # ------------------------------------------------------------ build ----
    def _fingerprint(self) -> str:
        return f"{self.cfg.arch_id}|{self.shape.name}|{self.tcfg.seed}"

    def _train_step(self, params, opt_state, batch):
        """One step, under a ``train.step`` span whose ``train.forward``,
        ``train.backward`` and ``train.optimizer`` children also time the
        device (``repro_torch.telemetry.spans``)."""
        cfg, tcfg, dev = self.cfg, self.tcfg, self.device
        with spans.span("train.step"):
            with spans.span("train.forward", device=dev):
                loss, metrics = T.loss_fn(params, cfg, batch,
                                          remat=tcfg.remat,
                                          compute_dtype=tcfg.compute_dtype)
            leaves = adamw.flatten(params)
            with spans.span("train.backward", device=dev):
                grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = adamw.unflatten(dict(zip(leaves, grads)))
            with spans.span("train.optimizer", device=dev):
                new_ef = None
                if tcfg.compression is not None:
                    ef = opt_state.pop("ef", None)
                    grads, new_ef, _ = tcfg.compression.apply(grads, ef)
                params, opt_state, om = adamw.update(grads, opt_state,
                                                     params, tcfg.opt)
                if new_ef is not None:
                    opt_state["ef"] = new_ef
        m = {k: v.detach() for k, v in metrics.items()}
        m.update(om)
        return params, opt_state, m

    def _build(self) -> None:
        cfg, shape, tcfg = self.cfg, self.shape, self.tcfg
        if self.mesh is not None:
            from repro_torch.launch.steps import make_train_bundle
            self.bundle = make_train_bundle(
                cfg, shape, self.mesh, remat=tcfg.remat,
                compute_dtype=tcfg.compute_dtype, opt_cfg=tcfg.opt,
                param_dtype=tcfg.param_dtype,
                microbatches=tcfg.microbatches,
                compression=tcfg.compression, collectives=self.collectives)
            self.step_fn = self.bundle.jitted()
        else:
            self.step_fn = self._train_step
        # drawn on the CPU and copied, so every device (and every rank)
        # starts from the same weights for a seed
        params = T.init_params(
            cfg, generator=torch.Generator().manual_seed(tcfg.seed),
            dtype=tcfg.param_dtype,
            device="cpu" if self.mesh is not None else self.device)
        self.load_params(params)
        self.step = 0

        dcfg = DataConfig(
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            with_frames=cfg.n_encoder_layers > 0,
            frame_len=cfg.encoder_seq_len, d_model=cfg.d_model)
        self.corpus = SyntheticCorpus(dcfg)
        self._start_prefetch(0)

    def load_params(self, params) -> None:
        """Start from the whole parameter tree ``params`` (on any device):
        under a mesh this rank keeps its shards; AdamW's moments (and
        compression's residuals) start at zero."""
        tcfg = self.tcfg
        if self.mesh is None:
            self.params = self._trainable(adamw.unflatten(
                {k: v.to(self.device)
                 for k, v in adamw.flatten(params).items()}))
        else:
            self.params = self._shards(params, self._pspecs["params"])
        self.opt_state = adamw.init(self.params)
        if tcfg.compression is not None and \
                tcfg.compression.config.error_feedback:
            self.opt_state["ef"] = tcfg.compression.init_state(self.params)

    # --------------------------------------------------------- the mesh ----
    @property
    def _pspecs(self):
        """The spec trees of the state the checkpoint holds."""
        params, opt, _ = (pytree.tree_map(
            lambda sh: sh.spec, t, is_leaf=lambda x: hasattr(x, "spec"))
            for t in self.bundle.in_shardings)
        return {"params": params, "opt": opt, "step": P()}

    def _shards(self, tree, specs):
        flat_s = flatten_specs(specs)
        return adamw.unflatten({
            k: local_shard(x, self.mesh, flat_s[k]).to(self.device)
            for k, x in adamw.flatten(tree).items()})

    def full_state(self) -> Dict[str, Any]:
        """{"params", "opt"}: the whole trees, gathered from every rank's
        shards (every rank of the mesh must call it); the trees themselves
        without a mesh."""
        if self.mesh is None:
            return {"params": self.params, "opt": self.opt_state}
        specs = self._pspecs
        out = {}
        for name, tree in (("params", self.params), ("opt", self.opt_state)):
            flat_s = flatten_specs(specs[name])
            out[name] = adamw.unflatten({
                k: reshard(x, self.mesh, flat_s[k], P(), self.collectives)
                for k, x in adamw.flatten(tree).items()})
        return out

    def _writes_checkpoints(self) -> bool:
        return self.mesh is None or all(
            self.mesh.get_local_rank(d) == 0 for d in self.mesh.mesh_dim_names)

    def _barrier(self) -> None:
        """Every rank of the mesh waits for all (a one-element all-reduce
        over every dim, through the collective service)."""
        self.collectives.all_reduce(
            torch.zeros(1, device=self.device), self.mesh,
            axes=tuple(self.mesh.mesh_dim_names))

    def _rows(self) -> np.ndarray:
        """This rank's rows of the global batch: its ``rules.batch`` block
        of each microbatch, microbatch after microbatch (the reference's
        microbatch i is the global rows [i B/m, (i + 1) B/m), split over
        the batch's ranks), so each micro-step of the bundle sees its
        block of the reference's microbatch."""
        m = self.tcfg.microbatches
        bax = self.bundle.in_shardings[2]["tokens"].spec[0]
        rows = torch.arange(self.shape.global_batch).reshape(m, -1)
        return local_shard(rows, self.mesh, P(None, bax)).reshape(-1).numpy()

    @staticmethod
    def _trainable(params):
        return adamw.unflatten({k: v.requires_grad_(True) for k, v in
                                adamw.flatten(params).items()})

    def _start_prefetch(self, start_step: int) -> None:
        tcfg = self.tcfg
        slow = set(tcfg.straggler_steps)

        def straggler(step: int) -> float:
            return tcfg.straggler_delay_s if step in slow else 0.0

        device_put = None
        if self.mesh is not None:
            rows, dev = self._rows(), self.device

            def device_put(host):
                return to_device({k: v[rows] for k, v in host.items()}, dev)
        self.prefetch = Prefetcher(
            self.corpus, depth=2,
            straggler_sim=straggler if slow else None,
            start_step=start_step, device=self.device, device_put=device_put)

    # ------------------------------------------------------------- run -----
    def run(self) -> Dict[str, Any]:
        tcfg = self.tcfg
        t0 = time.perf_counter()
        restarts = 0
        while self.step < tcfg.steps:
            try:
                self._run_inner()
            except InjectedFault:        # any typed fault kind restarts
                restarts += 1
                self.prefetch.stop()
                self.restore()                 # checkpoint/restart path
                self._start_prefetch(self.step)
        self.prefetch.stop()
        self.ckpt.wait()
        return {
            "final_step": self.step,
            "restarts": restarts,
            "skipped_steps": self.skipped_steps,
            "wall_s": time.perf_counter() - t0,
            "final_loss": (self.metrics_log[-1]["loss"]
                           if self.metrics_log else float("nan")),
        }

    def _run_inner(self) -> None:
        tcfg = self.tcfg
        while self.step < tcfg.steps:
            if self.step == tcfg.fail_at_step:
                tcfg.fail_at_step = -1          # fire once
                raise SimulatedFailure(f"injected at step {self.step}")
            maybe_fire(tcfg.fault_plan, "train.step")
            got = self.prefetch.get(timeout=tcfg.batch_timeout_s)
            if got is None:                     # straggler: skip dispatch
                self.skipped_steps.append(self.step)
                continue
            data_step, batch = got
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % tcfg.log_every == 0 or self.step == tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step
                self.metrics_log.append(m)
            if tcfg.ckpt_every and self.step % tcfg.ckpt_every == 0:
                self.save()

    # ------------------------------------------------------ checkpointing ---
    def save(self, blocking: bool = False) -> None:
        state = dict(self.full_state(),
                     step=torch.tensor(self.step, dtype=torch.int32))
        if self._writes_checkpoints():
            self.ckpt.save(self.step, state, fingerprint=self._fingerprint(),
                           blocking=blocking)

    def restore(self, step: Optional[int] = None) -> None:
        if self.mesh is None:
            like = {"params": self.params, "opt": self.opt_state,
                    "step": torch.tensor(0, dtype=torch.int32)}
        else:
            # the writer's last save is published before any rank reads
            self.ckpt.wait()
            self._barrier()
            # whole-shape host trees in this trainer's leaf order (the
            # order the global norm sums in)
            like = {"step": torch.tensor(0, dtype=torch.int32)}
            for name, tree, abstract in zip(
                    ("params", "opt"), (self.params, self.opt_state),
                    self.bundle.abstract_args):
                whole = adamw.flatten(abstract)
                like[name] = adamw.unflatten({
                    k: torch.empty(whole[k].shape, dtype=whole[k].dtype)
                    for k in adamw.flatten(tree)})
        state, at = self.ckpt.restore(like, step=step,
                                      expect_fingerprint=self._fingerprint())
        if self.mesh is None:
            self.params = self._trainable(state["params"])
            self.opt_state = state["opt"]
        else:
            specs = self._pspecs
            self.params = self._shards(state["params"], specs["params"])
            self.opt_state = self._shards(state["opt"], specs["opt"])
        self.step = int(state["step"])
