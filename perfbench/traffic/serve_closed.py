"""Closed-loop serving through the port's paged engine.

``clients`` clients each send their next request as soon as the last one
completes, through ``repro_torch.serve.engine.ServingEngine.submit`` and
``step`` over ``repro_torch.core.services.mmu.MMU``.  The requests'
prompt and output lengths are fixed quantiles of the cell's distributions,
in one order (drawn once, from ``ORDER_SEED``) in which every run of
``clients`` consecutive requests holds one length from each stratum, and
which requests sample is fixed the same way: every seed gets the same
work in the same order.  The seed draws the token ids (and the weights
and the sampling keys).  Set-up serves one short request to build the
engine's kernels, then starts the clients ``stagger_steps``
engine steps apart, so the window opens on a mix of prefilling and
decoding rows, at the same engine step for every seed.

The window is a stretch of that same loop.  The check, once it has
closed: a sample of the greedy requests completed in the window, drawn
from the seed with the longest among them, is run through the plain
float32 reference over prompt and served tokens; ``logit_gap`` is the
widest gap by which a served token's reference logit lies below the
reference's best at its position.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Any, Dict, List

import numpy as np

from perfbench import flops, harness, weights

ORDER_SEED = 0
# One short greedy request that set-up serves to its end before the first
# client starts: it builds the engine's kernels (nvcc, in a checkout's
# first run), so that no client's request waits on a build.  Were the
# build inside a client's decode, the requests decoding across it would
# carry its seconds into their time per output token when they complete
# in the window.
WARMUP_PROMPT, WARMUP_TOKENS = 16, 2


def lengths(n: int, spec: Dict[str, Any]) -> List[int]:
    """``n`` lengths at fixed quantiles of the distribution ``spec``
    (``lognormal``: ``median``, ``sigma``; ``uniform``), clipped to
    [``min``, ``max``]: the same multiset for every seed."""
    lo, hi = spec["min"], spec["max"]
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(q))
                for q in qs]
    elif spec["dist"] == "uniform":
        vals = [lo + (hi - lo) * q for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(min(max(round(v), lo), hi)) for v in vals]


def stratified(values, k: int, rng) -> list:
    """``values`` in an order, drawn from ``rng``, in which every run of
    ``k`` consecutive entries (k dividing their count) holds one entry of
    each of the k strata of the sorted values: any stretch of the traffic
    sees the same mix of sizes, whatever the seed."""
    vals = sorted(values)
    m = len(vals) // k
    if m * k != len(vals):
        raise ValueError(f"{len(vals)} requests do not fill strata of {k}")
    picks = [rng.permutation(vals[s * m:(s + 1) * m]) for s in range(k)]
    out = []
    for b in range(m):
        out += rng.permutation([picks[s][b] for s in range(k)]).tolist()
    return out


def requests(traffic: Dict[str, Any], vocab: int, seed: int):
    """The cell's requests for ``seed``: dicts of ``prompt`` (list of
    ids), ``max_new_tokens`` and ``sampled``.  Lengths and sampling are
    stratified over runs of ``clients`` requests, in the one order of
    ``ORDER_SEED``; the ids are ``seed``'s."""
    order = np.random.default_rng([ORDER_SEED, 5])
    n, k = traffic["requests"], traffic["clients"]
    plens = stratified(lengths(n, traffic["prompt"]), k, order)
    outs = stratified(lengths(n, traffic["output"]), k, order)
    n_sampled = round(traffic["sampled_share"] * n)
    sampled = stratified([i < n_sampled for i in range(n)], k, order)
    rng = np.random.default_rng([int(seed), 1])
    return [{"prompt": rng.integers(0, vocab, size=int(plens[i])).tolist(),
             "max_new_tokens": int(outs[i]), "sampled": bool(sampled[i])}
            for i in range(n)]


def kv_written(req) -> int:
    """Positions of ``req`` whose KV is in the pools."""
    if req.prefill_pos >= 0:
        return req.prefill_pos
    if req.out_tokens:
        return len(req.prompt) + len(req.out_tokens) - 1
    return 0


class Loop:
    """The clients of a closed loop over one engine."""

    def __init__(self, eng, reqs, traffic):
        self.eng = eng
        self.reqs = reqs
        self.t = traffic
        self.next = 0
        self.seen = 0
        self.submitted: List[Any] = []

    def submit(self) -> None:
        if self.next >= len(self.reqs):
            raise RuntimeError("the cell's requests ran out: raise "
                               "traffic.requests")
        spec = self.reqs[self.next]
        self.next += 1
        kw = ({"temperature": self.t["temperature"], "top_p": self.t["top_p"]}
              if spec["sampled"] else {})
        self.eng.submit(spec["prompt"], max_new_tokens=spec["max_new_tokens"],
                        **kw)
        self.submitted.append(self.eng.queue[-1])

    def step(self):
        """One engine step, then a new request for each client whose
        request completed.  Returns the step's work: (spans of positions
        run through the layers, LM-head rows, KV lengths the decode
        kernel read)."""
        eng = self.eng
        before = [(r, kv_written(r), len(r.out_tokens))
                  for r in list(eng.queue) + [s for s in eng.slots if s]]
        eng.step()
        spans, head, decode = [], 0, []
        for r, kv0, n0 in before:
            kv1, n1 = kv_written(r), len(r.out_tokens)
            if kv1 > kv0:
                spans.append((kv0, kv1))
            head += n1 - n0
            if n1 - n0 - (n0 == 0) > 0:
                decode.append(kv1)
        for _ in eng.completed[self.seen:]:
            self.submit()
        self.seen = len(eng.completed)
        return spans, head, decode


def _p90(xs):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), 90))


class Runner:
    def __init__(self, cell, config, seed, device):
        self.cell, self.config, self.seed = cell, config, int(seed)
        self.device = device
        self.t = cell["traffic"]

    def setup(self) -> None:
        harness.use_program()
        from repro_torch.core.services.mmu import MMU, MMUConfig
        from repro_torch.serve.engine import ServingEngine
        e = self.cell["engine"]
        self.params = weights.make(self.config, self.seed,
                                   harness.torch_dtype(self.config["dtype"]),
                                   self.device)
        self.mmu = MMU(MMUConfig(page_size=e["page_size"],
                                 n_pages=e["n_pages"]))
        self.eng = ServingEngine(
            harness.model_config(self.config), self.params, self.mmu,
            max_batch=e["max_batch"], max_len=e["max_len"], seed=self.seed,
            prefill_chunk=e["prefill_chunk"], device=self.device)
        warm = np.random.default_rng([self.seed, 6]).integers(
            0, self.config["vocab_size"], size=WARMUP_PROMPT).tolist()
        self.eng.submit(warm, max_new_tokens=WARMUP_TOKENS)
        while not self.eng.completed:
            self.eng.step()
        self.loop = Loop(self.eng, requests(self.t, self.config["vocab_size"],
                                            self.seed), self.t)
        self.loop.seen = len(self.eng.completed)
        for c in range(self.t["clients"]):
            self.loop.submit()
            for _ in range(self.t["stagger_steps"]):
                self.loop.step()

    def window(self, seconds, tracer) -> harness.Window:
        eng, loop = self.eng, self.loop
        c0 = (eng.prefill_s, eng.prefill_computed, eng.prefill_skipped,
              eng.tokens_out)
        decode_ms, traced = [], []
        trace_from = seconds * self.t["trace_at"]
        t_open = time.perf_counter()
        while time.perf_counter() - t_open < seconds:
            if tracer.enabled and time.perf_counter() - t_open >= trace_from:
                tracer.start()
            n_dec = len(eng.decode_step_times)
            if tracer.active:
                import torch
                with torch.profiler.record_function("perfbench.serve.step"):
                    traced.append(loop.step())
                if len(traced) == self.t["trace_steps"]:
                    tracer.stop()
            else:
                loop.step()
                decode_ms += [1e3 * x for x in eng.decode_step_times[n_dec:]]
        tracer.stop()
        t_close = time.perf_counter()
        wall = t_close - t_open

        first = [r for r in loop.submitted
                 if r.out_tokens and t_open <= r.t_first_token <= t_close]
        done = [r for r in eng.completed if t_open <= r.t_done <= t_close]
        vocab = self.config["vocab_size"]
        failed = sum(1 for r in done
                     if len(r.out_tokens) != r.max_new_tokens
                     or not all(0 <= x < vocab for x in r.out_tokens))
        prefill_s = eng.prefill_s - c0[0]
        computed = eng.prefill_computed - c0[1]
        skipped = eng.prefill_skipped - c0[2]
        e2e = {
            "serve_tokens_per_s": (sum(len(r.prompt) for r in first)
                                   + eng.tokens_out - c0[3]) / wall,
            "ttft_p90_ms": 1e3 * _p90([r.t_first_token - r.t_submit
                                       for r in first]),
            "tpot_p90_ms": 1e3 * _p90([(r.t_done - r.t_first_token)
                                       / (len(r.out_tokens) - 1)
                                       for r in done]),
        }
        counters = {
            "window_s": wall, "requests_first_token": len(first),
            "requests_completed": len(done),
            "decode_step_ms": decode_ms,
            "prefill_s": prefill_s, "prefill_computed": computed,
            "prefill_skipped": skipped, "traced_steps": traced,
            "page_size": self.cell["engine"]["page_size"],
            "kv_bytes": flops.DTYPE_BYTES[self.config["dtype"]],
        }
        self.sample = self._sample([r for r in done if r.temperature == 0])
        return harness.Window(e2e, counters, len(first), failed)

    def _sample(self, greedy):
        """Greedy requests completed in the window, drawn from the seed,
        the longest first, until ``sample_tokens`` served tokens."""
        if not greedy:
            return []
        longest = max(greedy, key=lambda r: len(r.prompt) + len(r.out_tokens))
        rest = [r for r in greedy if r is not longest]
        rng = np.random.default_rng([self.seed, 2])
        out, n = [longest], len(longest.out_tokens)
        for i in rng.permutation(len(rest)):
            if n >= self.t["sample_tokens"]:
                break
            out.append(rest[i])
            n += len(rest[i].out_tokens)
        return [(list(r.prompt), list(r.out_tokens)) for r in out]

    def release(self) -> None:
        """Free the engine, its pools and its MMU; the weights stay for the
        reference."""
        del self.eng, self.mmu, self.loop
        gc.collect()
        if self.device == "cuda":
            import torch
            torch.cuda.empty_cache()

    def gaps(self, *, control: bool = False) -> List[float]:
        """Per sampled request, the widest gap of a served token below the
        reference's best (``control``: of the token the reference computed
        in fp8 puts first)."""
        ref = harness.reference_module(self.config["reference"])
        return [ref.served_gap(self.params, self.config, prompt, out,
                               control=control)
                for prompt, out in self.sample]

    def check(self) -> Dict[str, tuple]:
        return self._compared(self.gaps())

    def controls(self) -> Dict[str, Dict[str, tuple]]:
        """The control: the reference in fp8 in the program's place."""
        return {"fp8_reference": self._compared(self.gaps(control=True))}

    def _compared(self, gaps) -> Dict[str, tuple]:
        return {"logit_gap": (max(gaps) if gaps else math.inf,
                              self.cell["limits"]["logit_gap"])}
