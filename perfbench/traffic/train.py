"""Training through the port's ``Trainer`` step.

Set-up makes the float32 master weights from the seed on the device,
builds one ``repro_torch.train.loop.Trainer`` (its own data prefetcher
stopped: the benchmark feeds it), loads those weights into it and drives
its step (``Trainer.step_fn``) through the first ``check_steps`` steps.
Those steps are the ones the check compares: each leaf's first gradient
as AdamW took it (its first moment after step 1 over 1 - b1) and each
leaf's change over them.  Their losses are not compared: no control or
fault reads a loss gap far enough above sound runs' to set a limit
between them (PERF.md gives the readings).  The window then drives the same
object's step on and on.  Every batch is a fresh seeded Zipf draw of
``batch`` x ``seq_len`` tokens over the vocabulary (ranks permuted by the
seed), so no two rows repeat.

The check, once the window has closed and the trainer is freed: the
plain float32 reference takes the same weights (made again from the seed)
through the same batches, and ``grad_gap`` and ``change_gap`` compare
the two by the worst leaf.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Any, Dict

import numpy as np

from perfbench import harness, weights


def zipf_probs(traffic, vocab: int, seed: int, device):
    """Token probabilities proportional to 1 / rank^alpha, the ranks of
    the ids permuted by the seed."""
    import torch
    ranks = np.random.default_rng([int(seed), 3]).permutation(vocab)
    p = 1.0 / ((ranks + 1.0) ** traffic["zipf_alpha"])
    return torch.as_tensor(p, dtype=torch.float32, device=device)


def batch_tokens(traffic, probs, seed: int, step: int):
    """Step ``step``'s (batch, seq_len) int32 tokens for ``seed``."""
    import torch
    state = np.random.SeedSequence([int(seed), 4, step]).generate_state(1)
    gen = torch.Generator(device=probs.device).manual_seed(int(state[0]))
    n = traffic["batch"] * traffic["seq_len"]
    ids = torch.multinomial(probs, n, replacement=True, generator=gen)
    return ids.reshape(traffic["batch"], traffic["seq_len"]).to(torch.int32)


def gaps(prog: Dict[str, Any], ref: Dict[str, Any], floor: float):
    """(grad gap, change gap) of a run against the reference.  A leaf's
    gap: |program's norm - reference's norm| over the larger of
    the reference's norm of that leaf and of the median leaf.  The change
    leaves out leaves whose reference gradient is under ``floor`` of the
    median leaf's (round-off alone moves them under AdamW)."""
    g_med = statistics.median(ref["first_grad"].values())
    grad = max(abs(prog["first_grad"][k] - v) / max(v, g_med)
               for k, v in ref["first_grad"].items())
    moved = [k for k, v in ref["first_grad"].items() if v >= floor * g_med]
    c_med = statistics.median(ref["change"][k] for k in moved)
    change = max(abs(prog["change"][k] - ref["change"][k])
                 / max(ref["change"][k], c_med) for k in moved)
    return grad, change


class Runner:
    def __init__(self, cell, config, seed, device):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device = device
        self.t = cell["traffic"]
        self.step_no = 0
        self.probs = None

    def batch(self, step: int):
        if self.probs is None:
            self.probs = zipf_probs(self.t, self.config["vocab_size"],
                                    self.seed, self.device)
        return {"tokens": batch_tokens(self.t, self.probs, self.seed, step)}

    def make_weights(self):
        return weights.make(self.config, self.seed, harness.torch_dtype(
            self.config["param_dtype"]), self.device)

    def setup(self) -> None:
        import torch
        harness.use_program()
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.optim import adamw
        from repro_torch.train.loop import TrainConfig, Trainer
        t = self.t
        tcfg = TrainConfig(
            steps=1 << 30, log_every=1 << 30, ckpt_every=0,
            ckpt_dir=str(harness.ROOT / "build" / "perfbench" / "ckpt"),
            seed=self.seed, remat=t["remat"],
            compute_dtype=harness.torch_dtype(self.config["dtype"]),
            param_dtype=harness.torch_dtype(self.config["param_dtype"]),
            opt=adamw.AdamWConfig(**t["opt"]))
        tr = Trainer(harness.model_config(self.config),
                     ShapeConfig(self.cell["name"], "train", t["seq_len"],
                                 t["batch"]), tcfg, device=self.device)
        tr.prefetch.stop()
        tr.load_params(self.make_weights())
        self.tr = tr
        for i in range(t["check_steps"]):
            self.step()
            if i == 0:
                b1 = t["opt"]["b1"]
                self.first_grad = {
                    k: float(m.norm()) / (1 - b1)
                    for k, m in adamw.flatten(tr.opt_state["m"]).items()}
        p0 = adamw.flatten(self.make_weights())
        self.change = {k: float((p.detach() - p0[k]).norm())
                       for k, p in adamw.flatten(tr.params).items()}
        del p0
        if self.device == "cuda":
            torch.cuda.synchronize()
            self.setup_peak = torch.cuda.max_memory_allocated()

    def step(self):
        tr = self.tr
        tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state,
                                                self.batch(self.step_no))
        self.step_no += 1
        return m

    def window(self, seconds, tracer) -> harness.Window:
        import torch
        from repro_torch.kernels.ssd import ssd as ssd_k
        cuda = self.device == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        trace_from = seconds * self.t["trace_at"]
        steps, traced, calls = 0, 0, [0, 0]
        last = None
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < seconds:
            if tracer.enabled and time.perf_counter() - t_open >= trace_from:
                tracer.start()
            if tracer.active:
                before = (ssd_k.LAUNCHES, ssd_k.BWD_LAUNCHES)
                with torch.profiler.record_function("perfbench.train.step"):
                    last = self.step()
                calls[0] += ssd_k.LAUNCHES - before[0]
                calls[1] += ssd_k.BWD_LAUNCHES - before[1]
                traced += 1
                if traced == self.t["trace_steps"]:
                    tracer.stop()
            else:
                last = self.step()
            steps += 1
        tracer.stop()
        loss = float(last["loss"])               # waits for the last step
        t_close = time.perf_counter()
        wall = t_close - t_open
        tokens = self.t["batch"] * self.t["seq_len"]
        peak = torch.cuda.max_memory_allocated() if cuda else None
        counters = {
            "window_s": wall, "steps": steps, "traced_steps": traced,
            "batch": self.t["batch"], "seq_len": self.t["seq_len"],
            "ssd_fwd_calls": calls[0], "ssd_bwd_calls": calls[1],
            "peak_bytes_window": peak,
        }
        return harness.Window(
            {"train_tokens_per_s": steps * tokens / wall}, counters, steps,
            0 if np.isfinite(loss) else 1,
            memory_peak_bytes=(max(peak, self.setup_peak) if cuda else None))

    def release(self) -> None:
        del self.tr
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def program_readings(self) -> Dict[str, Any]:
        return {"first_grad": self.first_grad, "change": self.change}

    def reference(self, *, control: bool = False, rows=None):
        """The plain reference through the checked steps (``control``: in
        fp8; ``rows``: only the first ``rows`` rows of each batch)."""
        ref = harness.reference_module(self.config["reference"])
        batches = [self.batch(i)["tokens"][:rows]
                   for i in range(self.t["check_steps"])]
        return ref.train(self.make_weights(), self.config, batches,
                         self.t["opt"], control=control)

    def check(self) -> Dict[str, tuple]:
        self.ref = self.reference()
        return self._compared(self.program_readings())

    def controls(self) -> Dict[str, Dict[str, tuple]]:
        """The control (the reference in fp8) and the fault of half the
        batch left out (the reference on the first half of each batch),
        each in the program's place; after ``check``."""
        return {"fp8_reference": self._compared(self.reference(control=True)),
                "half_batch": self._compared(
                    self.reference(rows=self.t["batch"] // 2))}

    def _compared(self, readings) -> Dict[str, tuple]:
        lim = self.cell["limits"]
        grad, change = gaps(readings, self.ref, self.t["moved_floor"])
        return {"grad_gap": (grad, lim["grad_gap"]),
                "change_gap": (change, lim["change_gap"])}
