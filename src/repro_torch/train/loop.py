"""Trainer: fault-tolerant, straggler-mitigating training loop.

Twin of ``repro.train.loop`` for one device:

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
mamba layer's scan the SSD kernels, forward and backward.  The
mesh bundle and microbatching (which the reference reads only under a
mesh) wait for the multi-device slice and raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.faults import FaultKind, InjectedFault, maybe_fire
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


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
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the mesh bundle waits for the "
                "multi-device slice")
        if tcfg.microbatches != 1:
            raise NotImplementedError(
                "TrainConfig.microbatches > 1 waits for the multi-device "
                "slice (the reference reads it only under a mesh)")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.metrics_log: List[Dict[str, float]] = []
        self.skipped_steps: List[int] = []
        self._build()

    # ------------------------------------------------------------ build ----
    def _fingerprint(self) -> str:
        return f"{self.cfg.arch_id}|{self.shape.name}|{self.tcfg.seed}"

    def _train_step(self, params, opt_state, batch):
        cfg, tcfg = self.cfg, self.tcfg
        loss, metrics = T.loss_fn(params, cfg, batch, remat=tcfg.remat,
                                  compute_dtype=tcfg.compute_dtype)
        leaves = adamw.flatten(params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = adamw.unflatten(dict(zip(leaves, grads)))
        new_ef = None
        if tcfg.compression is not None:
            ef = opt_state.pop("ef", None)
            grads, new_ef, _ = tcfg.compression.apply(grads, ef)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             tcfg.opt)
        if new_ef is not None:
            opt_state["ef"] = new_ef
        m = {k: v.detach() for k, v in metrics.items()}
        m.update(om)
        return params, opt_state, m

    def _build(self) -> None:
        cfg, shape, tcfg = self.cfg, self.shape, self.tcfg
        self.step_fn = self._train_step
        # drawn on the CPU and copied, so every device starts from the
        # same weights for a seed
        params = T.init_params(
            cfg, generator=torch.Generator().manual_seed(tcfg.seed),
            dtype=tcfg.param_dtype, device=self.device)
        self.params = self._trainable(params)
        self.opt_state = adamw.init(self.params)
        if tcfg.compression is not None and \
                tcfg.compression.config.error_feedback:
            self.opt_state["ef"] = tcfg.compression.init_state(self.params)
        self.step = 0

        dcfg = DataConfig(
            seq_len=shape.seq_len, global_batch=shape.global_batch,
            vocab_size=cfg.vocab_size, seed=tcfg.seed,
            with_frames=cfg.n_encoder_layers > 0,
            frame_len=cfg.encoder_seq_len, d_model=cfg.d_model)
        self.corpus = SyntheticCorpus(dcfg)
        self._start_prefetch(0)

    @staticmethod
    def _trainable(params):
        return adamw.unflatten({k: v.requires_grad_(True) for k, v in
                                adamw.flatten(params).items()})

    def _start_prefetch(self, start_step: int) -> None:
        tcfg = self.tcfg
        slow = set(tcfg.straggler_steps)

        def straggler(step: int) -> float:
            return tcfg.straggler_delay_s if step in slow else 0.0

        self.prefetch = Prefetcher(
            self.corpus, depth=2,
            straggler_sim=straggler if slow else None,
            start_step=start_step, device=self.device)

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
        state = {"params": self.params, "opt": self.opt_state,
                 "step": torch.tensor(self.step, dtype=torch.int32)}
        self.ckpt.save(self.step, state, fingerprint=self._fingerprint(),
                       blocking=blocking)

    def restore(self, step: Optional[int] = None) -> None:
        like = {"params": self.params, "opt": self.opt_state,
                "step": torch.tensor(0, dtype=torch.int32)}
        state, at = self.ckpt.restore(like, step=step,
                                      expect_fingerprint=self._fingerprint())
        self.params = self._trainable(state["params"])
        self.opt_state = state["opt"]
        self.step = int(state["step"])
