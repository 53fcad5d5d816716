"""Data pipeline: deterministic synthetic corpus + prefetching loader.

Twin of ``repro.data.pipeline``.  ``DataConfig`` and ``SyntheticCorpus``
are the reference's, line for line (numpy ``RandomState``), so a batch is
bit-identical across the two packages: batch(step) is a pure function of
(seed, step), and a restart resumes on the same data.  ``Prefetcher``
stages batches on the device from a background thread: a pinned host
tensor copied with ``non_blocking=True`` on the card, so the copy overlaps
the running step; the straggler skip and the ``get`` timeout are the
reference's.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    mean_doc_len: int = 512        # documents are packed into rows
    bos_id: int = 1
    eos_id: int = 2
    with_frames: bool = False      # audio stub (whisper): emit frames too
    frame_len: int = 0
    d_model: int = 0


class SyntheticCorpus:
    """Zipf-ish random documents, packed: batch(step) is pure in (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.RandomState((c.seed * 1_000_003 + step) % (2**31))
        rows = np.empty((c.global_batch, c.seq_len), np.int32)
        for i in range(c.global_batch):
            toks = []
            while len(toks) < c.seq_len:
                dlen = max(int(rng.exponential(c.mean_doc_len)), 8)
                doc = rng.zipf(1.3, size=dlen) % (c.vocab_size - 3) + 3
                toks.extend([c.bos_id, *doc.tolist(), c.eos_id])
            rows[i] = np.asarray(toks[:c.seq_len], np.int32)
        out = {"tokens": rows}
        if c.with_frames:
            out["frames"] = rng.randn(
                c.global_batch, c.frame_len, c.d_model).astype(np.float32)
        return out


def to_device(host: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch -> tensors on ``device``; on the card through pinned
    memory with a non-blocking copy on the current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in host.items()}


class Prefetcher:
    """Background thread staging batch(step+1..step+depth) onto device.

    ``straggler_sim`` optionally injects host delays; ``get`` takes a
    timeout so the trainer can *skip* a straggling batch (the data-dispatch
    mitigation: training proceeds with the next ready batch, the skipped
    step id is logged for exactly-once accounting).  ``device`` None means
    the CUDA card."""

    def __init__(self, corpus: SyntheticCorpus, *, depth: int = 2,
                 device_put: Optional[Callable[[Any], Any]] = None,
                 straggler_sim: Optional[Callable[[int], float]] = None,
                 start_step: int = 0, device=None):
        self.corpus = corpus
        self.depth = depth
        if device_put is None:
            dev = resolve_device(device)
            device_put = lambda host: to_device(host, dev)  # noqa: E731
        self.device_put = device_put
        self.straggler_sim = straggler_sim
        self._q: "queue.Queue[tuple[int, Any]]" = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self.skipped: list[int] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            step = self._next
            self._next += 1
            if self.straggler_sim is not None:
                delay = self.straggler_sim(step)
                if delay > 0:
                    time.sleep(delay)
            host = self.corpus.batch(step)
            dev = self.device_put(host)
            while not self._stop.is_set():
                try:
                    self._q.put((step, dev), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: Optional[float] = None):
        """Next ready (step, batch); None on timeout (caller may skip)."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
