"""Fault-tolerant checkpointing: state save/restore with async writes,
atomic publication, retention, and restore into any process.

Twin of ``repro.checkpoint.manager`` with the same on-disk layout, so the
two packages read each other's checkpoints:
``<dir>/step_<N>/manifest.json`` + ``<sha1(path)[:16]>.npy`` per leaf,
where a leaf's path is its dict keys joined by "/".  Leaves are written
as whole host arrays, so a checkpoint does not depend on the device it was
taken on.  Publication is atomic (tmp dir + rename); an interrupted save
can never corrupt the latest checkpoint.  numpy has no bfloat16: such
leaves are written as float32 and cast back on restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.optim.adamw import flatten, unflatten


def _host(x) -> np.ndarray:
    """A host copy of ``x``.  Always a copy: on the CPU ``.cpu().numpy()``
    would share the live storage, which the trainer updates in place
    while an asynchronous save still writes it."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.save_count = 0

    # ------------------------------------------------------------- save ----
    def save(self, step: int, state: Any, *, fingerprint: str = "",
             blocking: bool = False) -> None:
        # snapshot to host synchronously, write in the background
        host = [(k, _host(x)) for k, x in flatten(state).items()]
        if self.async_save and not blocking:
            self.wait()                       # at most one in-flight save
            self._thread = threading.Thread(
                target=self._write, args=(step, host, fingerprint),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, fingerprint)

    def _write(self, step: int, host, fingerprint: str) -> None:
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "fingerprint": fingerprint,
                    "created": time.time(), "leaves": {}}
        for key, arr in host:
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                 # atomic publication
        self.save_count += 1
        self._retain()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _retain(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: Optional[int] = None,
                expect_fingerprint: str = "") -> Any:
        """Restore into the structure of ``like`` (nested dicts of
        tensors): each leaf comes back with its ``like`` leaf's dtype, on
        its device.  Returns (state, step)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        if expect_fingerprint and manifest["fingerprint"] != expect_fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {manifest['fingerprint']!r} != "
                f"expected {expect_fingerprint!r}")
        leaves = {}
        for key, leaf_like in flatten(like).items():
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = np.load(d / meta["file"])
            leaves[key] = torch.from_numpy(arr).to(
                device=leaf_like.device, dtype=leaf_like.dtype)
        return unflatten(leaves), step
