"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into the
git-ignored ``build/``, one ``nvcc`` per source, all at once), holds each
kernel against its plain PyTorch version on the card, drives the port's
two main paths at the full width of smollm-135m (seeded random weights):
requests served through ``repro_torch.serve.engine.ServingEngine`` and
training steps through ``repro_torch.train.loop.Trainer``, checks the card
against the CPU on the reduced model, times the kernels and profiles a
decode step and a training step.  Phases, in order:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel, print the build seconds and each kernel's
     registers and spills;
  3. kernels vs plain versions on the card (fp32 and bf16): paged
     attention with and without the split of rows over several blocks;
     the flash-attention forward, dq and dkv kernels on the reference's
     test cases and the training shape, and ``mha_fused``'s gradient
     against autograd of the plain forward;
  4. serving main path: 24 requests through the engine at full width, bf16;
  5. training main path: 20 steps of ``Trainer`` at full width, sequence
     2048, batch 8, fp32 masters with bf16 compute, a checkpoint every 5
     steps and an injected failure at step 12 (one restart);
  6. card vs CPU on the reduced model, fp32: decode_step_paged, and 3
     ``Trainer`` steps from the same weights;
  7. kernel timing at the main paths' shapes, with each kernel's bound and
     a PyTorch library call as yardstick where one computes the same
     function;
  8. profiles: where a steady decode step (every slot full) and a training
     step spend their time (host wall per step untraced and traced, device
     busy time per step, the device's idle share, launches per step, the
     kernels that take the most device time).

Each main path runs with every kernel's launch count set to 0 just before
it and read just after it.  Any failed phase ends the script with a
non-zero exit and no result line.  The line before the last is a JSON
object describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PA_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
PA_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:47"
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
FA_REPLACES = {
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:36",
    "flash_attention_dq":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:48",
    "flash_attention_dkv":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:97"}
# H100 SXM data sheet (NVIDIA), dense rates: HBM3 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s (the
# flash kernels compute float32 FMA for both input types; a float32 input
# held to atol 2e-5 cannot go through TF32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash-attention gradients: float32 atol 5e-4 (the reference's backward
# tests); bf16 against the float32 plain version on the same bf16 values:
# atol 5e-4 plus rtol 2^-8, since the kernels compute in float32 and round
# each stored gradient to bf16 once (at most 2^-9 of its value)
GRAD_ATOL, GRAD_RTOL = 5e-4, {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8}
# (B, H, K, Sq, Sk, D, causal, window): tests/test_kernels.py FA_CASES and
# BWD_CASES, and the training path's shape
FA_CASES = [(2, 4, 2, 256, 256, 64, True, 0),
            (1, 8, 8, 128, 384, 128, True, 0),
            (2, 4, 1, 200, 200, 64, True, 0),
            (1, 4, 2, 256, 256, 64, True, 128),
            (1, 2, 2, 128, 256, 64, False, 0),
            (1, 4, 2, 128, 128, 64, True, 0)]
BWD_CASES = [(1, 4, 2, 128, 128, 64, True, 0),
             (2, 2, 1, 96, 160, 64, True, 0),
             (1, 4, 4, 128, 128, 64, False, 0),
             (1, 2, 2, 128, 128, 64, True, 64)]
FA_MAIN = (8, 9, 3, 2048, 2048, 64, True, 0)
TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 20, 12, 5
TRAIN_PROFILE_STEPS = 5
# (B, H, K, D, page, maxp, n_pages) from tests/test_kernels.py PA_CASES
PA_CASES = [(2, 8, 2, 64, 128, 4, 16), (3, 4, 4, 128, 64, 6, 32),
            (1, 16, 8, 64, 256, 3, 8)]
MAIN_SHAPE = (16, 9, 3, 64, 16, 64, 2048)
PROFILE_STEPS = 32


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def pa_inputs(shape, lens, dtype, gen, tables=None):
    """Random q and pools on the card; random distinct pages per row."""
    b, h, kh, d, page, maxp, n_pages = shape
    dev = gen.device
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, page, kh, d, generator=gen, device=dev)
    vp = torch.randn(n_pages, page, kh, d, generator=gen, device=dev)
    lens = torch.tensor(lens, dtype=torch.int32)
    if tables is None:
        tables = torch.full((b, maxp), -1, dtype=torch.int32)
        pick = torch.Generator().manual_seed(b * 1000 + n_pages)
        for i in range(b):
            need = -(-int(lens[i]) // page)
            tables[i, :need] = torch.randperm(n_pages, generator=pick)[:need]
    return (q, kp.to(dtype), vp.to(dtype), tables.to(dev), lens.to(dev))


def main_lens(b, page, maxp):
    rs = np.random.RandomState(7)
    return [int(x) for x in rs.randint(0, page * maxp + 1, size=b)]


def phase_kernels(pa, ref, gen):
    """Kernel vs plain version; returns the main shape's bf16 error."""
    cases = []
    for i, shape in enumerate(PA_CASES):
        b, page, maxp = shape[0], shape[4], shape[5]
        lens = [min((j + 1) * (page + 7), page * maxp) for j in range(b)]
        cases.append((f"pa{i}", shape, lens, None))
    ragged = torch.full((3, 7), -1, dtype=torch.int32)
    ragged[1, :2] = torch.tensor([5, 9])
    ragged[2, :7] = torch.tensor([1, 2, 3, -1, 4, 6, 7])
    cases.append(("ragged", (3, 4, 2, 64, 16, 7, 32), [0, 32, 100], ragged))
    # enough blocks to fill the card without splitting rows: one pass
    cases.append(("wide", (192, 9, 3, 64, 16, 8, 2048),
                  main_lens(192, 16, 8), None))
    cases.append(("main", MAIN_SHAPE, main_lens(16, 16, 64), None))
    main_err = None
    for name, shape, lens, tables in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, ln = pa_inputs(shape, lens, dtype, gen, tables)
            out = pa.paged_attention(q, kp, vp, tab, ln)
            want = ref(q.float(), kp.float(), vp.float(), tab, ln)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} non-finite")
            err = float((out.float() - want).abs().max())
            tol = ATOL[dtype]
            splits = pa.n_splits(q.device, shape[0], shape[1], shape[2],
                                 shape[5])
            print(f"[3] {name:6s} {str(dtype):14s} splits={splits:2d} "
                  f"max_abs_err={err:.3e} atol={tol:g}")
            check(err <= tol, f"kernel vs plain {name} {dtype}: {err}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = err
    return main_err


def main_engine(cfg, params):
    """The main path's MMU and engine: page 16, 2048 pages (0.75 GB of bf16
    KV pools), 16 slots, max_len 1024, prefill chunks of 256."""
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.serve.engine import ServingEngine
    mmu = MMU(MMUConfig(page_size=16, n_pages=2048))
    return mmu, ServingEngine(cfg, params, mmu, max_batch=16, max_len=1024,
                              prefill_chunk=256, device="cuda")


def phase_main_path(card):
    """Returns the main path's paged-attention launches, config and
    weights."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models.transformer import init_params

    cfg = get_config("smollm-135m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, generator=gen, dtype=torch.bfloat16,
                         device="cuda")

    # warm-up: CUDA context, cuBLAS handles and the kernel library load
    _, warm = main_engine(cfg, params)
    warm.submit(list(range(3, 40)), max_new_tokens=4)
    warm.submit(list(range(5, 300)), max_new_tokens=4, temperature=0.8,
                top_k=40, top_p=0.9)
    warm.run()
    del warm

    rs = np.random.RandomState(0)
    prefix = rs.randint(0, cfg.vocab_size, size=128).tolist()
    mmu, eng = main_engine(cfg, params)
    reqs = []
    for i in range(24):
        plen = int(rs.randint(64, 769))
        body = rs.randint(0, cfg.vocab_size, size=plen).tolist()
        if i % 3 == 0:     # shares the prefix; short enough for one shot
            prompt = prefix + body[:int(rs.randint(32, 129))]
        else:
            prompt = body
        mode = ({}, {}, {"temperature": 0.8},
                {"temperature": 0.8, "top_k": 40, "top_p": 0.9})[i % 4]
        reqs.append((prompt, mode))
    _zero_counts()
    for prompt, mode in reqs:
        eng.submit(prompt, max_new_tokens=64, **mode)
    stats = eng.run()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(stats["completed"] == 24, f"completed {stats['completed']}/24")
    check(mmu.utilization()["pages_used"] == 0, "pages leaked")
    for r in eng.completed:
        check(len(r.out_tokens) == 64, f"rid {r.rid} has "
              f"{len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"rid {r.rid} token outside the vocabulary")
    check(launches == cfg.n_layers * eng.steps,
          f"LAUNCHES {launches} != {cfg.n_layers} x {eng.steps} steps")
    check(eng.prefill_skipped > 0, "no prompt page was shared")
    st = np.asarray(eng.decode_step_times) * 1e3
    line = {
        "card": card, "model": "smollm-135m (random weights, bf16)",
        "requests": 24, "decode_steps": eng.steps,
        "tokens": stats["tokens"], "wall_s": stats["wall_s"],
        "tokens_per_s": stats["tokens_per_s"],
        "decode_step_ms_mean": float(st.mean()),
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "decode_step_ms_p99": float(np.percentile(st, 99)),
        "prefill_tokens": eng.prefill_computed,
        "prefill_skipped": eng.prefill_skipped,
        "prefill_tokens_per_s": eng.prefill_computed / eng.prefill_s,
        **{k: stats[k] for k in ("ttft_p50_ms", "ttft_p99_ms",
                                 "tpot_p50_ms", "tpot_p99_ms")},
        "pa_launches": launches,
    }
    print("[4] " + json.dumps(line))
    return launches, cfg, params


def phase_card_vs_cpu():
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.paged_model import (decode_step_paged, make_pools,
                                               prefill_shared_paged)

    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    page, n_pages, maxp = 16, 32, 8
    plens = [5, 17, 16, 30, 0]                  # the last row is inactive
    b = len(plens)
    tables = torch.full((b, maxp), -1, dtype=torch.int32)
    nxt = 0
    for i, n in enumerate(plens):
        if n:
            need = -(-(n + 9) // page)
            tables[i, :need] = torch.arange(nxt, nxt + need)
            nxt += need
    rs = np.random.RandomState(3)
    toks = torch.zeros(b, 32, dtype=torch.int32)
    for i, n in enumerate(plens):
        toks[i, :n] = torch.as_tensor(rs.randint(0, cfg.vocab_size, n))
    lens = torch.tensor(plens, dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    temps = torch.zeros(b)
    rids = torch.arange(1, b + 1, dtype=torch.int32)

    def to(tree, dev):
        return ({k: to(v, dev) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))

    runs = {}
    teacher = None
    for dev in ("cpu", "cuda"):
        p = to(params, dev)
        pools = make_pools(cfg, n_pages, page, dtype=torch.float32,
                           device=dev)
        first = prefill_shared_paged(
            p, pools, toks.to(dev), lens.to(dev), zeros.to(dev),
            zeros.to(dev), tables.to(dev), 0, temps.to(dev),
            seq_ids=rids.to(dev), cfg=cfg, page_size=page)
        out, cur_lens = [first.cpu()], lens.to(dev)
        last = first if teacher is None else teacher[0].to(dev)
        for s in range(8):
            nt, cur_lens = decode_step_paged(
                p, pools, tables.to(dev), cur_lens, last, 0, temps.to(dev),
                seq_ids=rids.to(dev), cfg=cfg, page_size=page)
            out.append(nt.cpu())
            # teacher forcing: both devices feed the CPU's tokens
            last = nt if teacher is None else teacher[s + 1].to(dev)
        torch.cuda.synchronize()
        runs[dev] = (out, {k: v[:-1].cpu() for k, v in pools.items()})
        teacher = out
    (ct, cp), (gt, gp) = runs["cpu"], runs["cuda"]
    live = [i for i, n in enumerate(plens) if n]
    for s, (a, g) in enumerate(zip(ct, gt)):
        check(bool((a[live] == g[live]).all()),
              f"greedy tokens differ at step {s}: {a} vs {g}")
    err = max(float((cp[k] - gp[k]).abs().max()) for k in ("k", "v"))
    print(f"[6] reduced smollm fp32, 8 teacher-forced decode steps: tokens "
          f"identical, pool max_abs_err={err:.3e} atol=1e-4")
    check(err <= 1e-4, f"pools differ by {err}")


def time_ms(fn, reps, flush):
    """Median CUDA-event time of ``fn`` with L2 flushed before each call."""
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(z))
    return float(np.median(times[3:]))


def phase_timing(pa, ref, gen, card):
    b, h, kh, d, page, maxp, n_pages = MAIN_SHAPE
    lens = main_lens(b, page, maxp)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, tab, ln = pa_inputs(MAIN_SHAPE, lens, dtype, gen)
        s = q.element_size()
        nbytes = (2 * q.numel() * s + sum(lens) * kh * d * 2 * s
                  + tab.numel() * 4 + ln.numel() * 4)
        before = pa.LAUNCHES
        k_ms = time_ms(lambda: pa.paged_attention(q, kp, vp, tab, ln), 50,
                       flush)
        pa.LAUNCHES = before          # timing launches are not main-path
        p_ms = time_ms(lambda: ref(q, kp, vp, tab, ln), 20, flush)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res[dtype] = (k_ms, p_ms, bound)
        print(f"[7] paged_attention {str(dtype):14s} B={b} H={h} K={kh} "
              f"D={d} page={page} maxp={maxp} sum(lens)={sum(lens)}: "
              f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"bound_ms={bound:.4f} (bytes {nbytes}) [{card}]")
    return res


def _union_ms(intervals):
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _profile_summary(prof, steps):
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "profile: the trace holds no device kernel")
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / steps
    by_name = {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
    return kernels, busy, by_name


def phase_decode_profile(cfg, params, card):
    """Fills every slot of the main path's engine, steps past admission and
    prefill, times PROFILE_STEPS decode steps untraced, then traces as many
    more with ``torch.profiler``.  The device's busy time per step is the
    union of the traced kernel intervals; its idle share is given against
    both the untraced and the traced step wall."""
    _, eng = main_engine(cfg, params)
    rs = np.random.RandomState(0)
    for i in range(eng.max_batch):
        prompt = rs.randint(0, cfg.vocab_size,
                            size=int(rs.randint(64, 769))).tolist()
        eng.submit(prompt, max_new_tokens=8 + 2 * PROFILE_STEPS + 4,
                   **({"temperature": 0.8} if i % 2 else {}))
    for _ in range(8):                       # admission, prefill, warm-up
        eng.step()
    check(all(r is not None and r.prefill_pos < 0 for r in eng.slots),
          "profile: a slot is not decoding after the warm-up steps")
    walls = []
    for _ in range(PROFILE_STEPS):           # each step ends on its token copy
        t0 = time.perf_counter()
        eng.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            eng.step()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    check(all(r is not None for r in eng.slots),
          "profile: a request finished inside the measured steps")
    kernels, busy, by_name = _profile_summary(prof, PROFILE_STEPS)
    total = sum(t for t, _ in by_name.values())
    pa_ms = sum(t for n, (t, _) in by_name.items()
                if "paged_attention" in n or "combine_kernel" in n)
    untraced = float(np.mean(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print("[8] decode " + json.dumps({
        "card": card, "model": "smollm-135m (random weights, bf16)",
        "batch": eng.max_batch, "steps": PROFILE_STEPS,
        "step_wall_ms_untraced_mean": untraced,
        "step_wall_ms_untraced_p50": float(np.percentile(walls, 50)),
        "step_wall_ms_untraced_p90": float(np.percentile(walls, 90)),
        "step_wall_ms_traced_mean": traced,
        "device_busy_ms_per_step": busy,
        "device_idle_share_untraced": 1 - busy / untraced,
        "device_idle_share_traced": 1 - busy / traced,
        "kernels_per_step": len(kernels) / PROFILE_STEPS,
        "paged_attention_share_of_kernel_time": pa_ms / total,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": t / PROFILE_STEPS,
             "calls": c / PROFILE_STEPS} for n, (t, c) in top]}))



# ------------------------------------------------------------ flash attention
def flash_inputs(case, dtype, gen, n=3):
    b, h, kh, sq, sk, d = case[:6]
    shapes = [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)]
    shapes += [(b, h, sq, d)] * (n - 3)
    return [torch.randn(*sh, generator=gen, device=gen.device).to(dtype)
            for sh in shapes]


def phase_flash_kernels(gen):
    """Forward, dq and dkv kernels vs the plain versions; returns the
    training shape's bf16 errors by kernel name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    main_err = {}
    cases = ([(f"fa{i}", c, True, False) for i, c in enumerate(FA_CASES)]
             + [(f"bwd{i}", c, False, True) for i, c in enumerate(BWD_CASES)]
             + [("main", FA_MAIN, True, True)])
    for name, case, fwd, bwd in cases:
        causal, window = case[6], case[7]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = flash_inputs(case, dtype, gen, n=4)
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            errs = {}
            if fwd:
                want_o, want_lse = attention_ref(
                    q.float(), k.float(), v.float(), causal=causal,
                    window=window)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(o).all()), f"{name} non-finite o")
                errs["o"] = float((o.float() - want_o).abs().max())
                errs["lse"] = float((lse - want_lse).abs().max())
                for key in ("o", "lse"):
                    check(errs[key] <= ATOL[dtype],
                          f"forward {name} {dtype} {key}: {errs[key]}")
                del want_o, want_lse
            if bwd:
                got = fab.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal, window=window)
                want = attention_bwd_ref(*(t.float() for t in
                                           (q, k, v, o, do)), lse,
                                         causal=causal, window=window)
                torch.cuda.synchronize()
                for key, g, w in zip(("dq", "dk", "dv"), got, want):
                    check(bool(torch.isfinite(g).all()),
                          f"{name} non-finite {key}")
                    diff = (g.float() - w).abs()
                    errs[key] = float(diff.max())
                    excess = float((diff - GRAD_ATOL
                                    - GRAD_RTOL[dtype] * w.abs()).max())
                    check(excess <= 0, f"backward {name} {dtype} {key}: "
                          f"max_abs_err {errs[key]}, {excess} past "
                          f"atol {GRAD_ATOL} + rtol {GRAD_RTOL[dtype]}")
                del got, want
            print(f"[3] flash {name:5s} {str(dtype):14s} "
                  + " ".join(f"{k}={e:.3e}" for k, e in errs.items()))
            if name == "main" and dtype == torch.bfloat16:
                main_err = {"flash_attention_fwd": errs["o"],
                            "flash_attention_dq": errs["dq"],
                            "flash_attention_dkv": max(errs["dk"],
                                                       errs["dv"])}
    for h, kh in ((2, 2), (4, 2)):           # as test_mha_fused_custom_vjp
        q, k, v = (t.requires_grad_(True) for t in flash_inputs(
            (1, h, kh, 128, 128, 64), torch.float32, gen))
        g1 = torch.autograd.grad((ops.mha_fused(q, k, v) ** 2).sum(),
                                 (q, k, v))
        g2 = torch.autograd.grad((attention_ref(q, k, v)[0] ** 2).sum(),
                                 (q, k, v))
        err = max(float((a - b).abs().max()) for a, b in zip(g1, g2))
        print(f"[3] mha_fused grad H={h} K={kh} vs autograd of the plain "
              f"forward: max_abs_err={err:.3e} atol=1e-3")
        check(err <= 1e-3, f"mha_fused gradient H={h} K={kh}: {err}")
    return main_err


def _flash_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    return {"flash_attention_fwd": fa.LAUNCHES,
            "flash_attention_dq": fab.DQ_LAUNCHES,
            "flash_attention_dkv": fab.DKV_LAUNCHES}


def _zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.paged_attention import paged_attention as pa
    pa.LAUNCHES = fa.LAUNCHES = fab.DQ_LAUNCHES = fab.DKV_LAUNCHES = 0


def phase_train(card):
    """The training main path.  Returns its flash-attention launches by
    kernel, the trainer (for the profile) and its timed step function."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = get_config("smollm-135m")
    b, s = FA_MAIN[0], FA_MAIN[3]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = Trainer(cfg, ShapeConfig("chip_smoke_train", "train", s, b),
                     TrainConfig(steps=TRAIN_STEPS, log_every=1,
                                 ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=ckpt,
                                 fail_at_step=TRAIN_FAIL_AT, seed=0,
                                 compute_dtype=torch.bfloat16,
                                 param_dtype=torch.float32,
                                 opt=AdamWConfig(warmup_steps=5,
                                                 total_steps=TRAIN_STEPS)),
                     device="cuda")
        step_fn, step_ms = tr.step_fn, []

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        tr.step_fn = timed
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        res = tr.run()
        torch.cuda.synchronize()
        launches = _flash_counts()
        pa_launches = pa.LAUNCHES
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = [m["loss"] for m in tr.metrics_log]
    runs = len(step_ms)
    restored = TRAIN_FAIL_AT // TRAIN_CKPT_EVERY * TRAIN_CKPT_EVERY
    check(res["restarts"] == 1, f"restarts {res['restarts']} != 1")
    check(res["final_step"] == TRAIN_STEPS,
          f"final_step {res['final_step']} != {TRAIN_STEPS}")
    check(runs == len(losses) == TRAIN_FAIL_AT + TRAIN_STEPS - restored,
          f"{runs} steps run, {len(losses)} logged; expected "
          f"{TRAIN_FAIL_AT + TRAIN_STEPS - restored}")
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    for name, n in launches.items():
        check(n == cfg.n_layers * runs,
              f"{name} launches {n} != {cfg.n_layers} x {runs} steps")
    check(pa_launches == 0, "the training path launched paged attention")
    st = np.asarray(step_ms)
    print("[5] " + json.dumps({
        "card": card, "model": "smollm-135m (random weights, fp32 masters, "
        "bf16 compute)", "seq_len": s, "batch": b,
        "steps": TRAIN_STEPS, "steps_run": runs, "restarts": res["restarts"],
        "restored_from_step": restored, "wall_s": res["wall_s"],
        "step_ms_p50": float(np.percentile(st, 50)),
        "step_ms_p90": float(np.percentile(st, 90)),
        "step_ms_first": float(st[0]),
        "tokens_per_s": b * s / float(np.percentile(st, 50)) * 1e3,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches}))
    return launches, tr, step_fn


def phase_train_card_vs_cpu():
    """Reduced smollm, fp32, TF32 off: 3 Trainer steps on each device from
    the same weights (drawn on the CPU for a seed) and the same data.
    Params are held to 2 x the summed learning rates plus 1e-6: AdamW's
    m / sqrt(v) turns a last-bit difference in the sign of a near-zero
    gradient into an update of +lr instead of -lr."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.train.loop import TrainConfig, Trainer

    cfg = get_config("smollm-135m").reduced()
    runs = {}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for dev in ("cpu", "cuda"):
            t = Trainer(cfg, ShapeConfig("t", "train", 128, 2), TrainConfig(
                steps=3, log_every=1, ckpt_every=0, seed=4, ckpt_dir=ckpt),
                device=dev)
            t.run()
            runs[dev] = ([m["loss"] for m in t.metrics_log],
                         {k: v.detach().cpu() for k, v in
                          adamw.flatten(t.params).items()},
                         sum(m["lr"] for m in t.metrics_log))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    (cl, cp, lr_sum), (gl, gp, _) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(cl, gl))
    p_err = max(float((cp[k] - gp[k]).abs().max()) for k in cp)
    p_tol = 2 * lr_sum + 1e-6
    print(f"[6] reduced smollm fp32, 3 Trainer steps: loss max_abs_err="
          f"{loss_err:.3e} atol=1e-4, params max_abs_err={p_err:.3e} "
          f"atol={p_tol:.3e}")
    check(loss_err <= 1e-4, f"losses differ: {cl} vs {gl}")
    check(p_err <= p_tol, f"params differ by {p_err}")


def _causal_pairs(sq, sk, causal):
    """(query, key) pairs that the causal mask leaves visible."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def phase_flash_timing(gen, card):
    """Each flash kernel at the training shape, bf16 and fp32: its time,
    its bound, the plain version's time and the library yardstick
    (``scaled_dot_product_attention``, never on the port's path)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    b, h, kh, sq, sk, d, causal, window = FA_MAIN
    pairs = _causal_pairs(sq, sk, causal) * b * h
    flops = {"flash_attention_fwd": 4 * d * pairs,      # q k^T, p v
             "flash_attention_dq": 6 * d * pairs,       # q k^T, do v^T, ds k
             "flash_attention_dkv": 8 * d * pairs}      # + p^T do, ds^T q
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = flash_inputs(FA_MAIN, dtype, gen, n=4)
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        _, delta = fab.flash_attention_dq(q, k, v, o, do, lse)
        e = q.element_size()
        nq, nk, nl = q.numel() * e, k.numel() * e, lse.numel() * 4
        nbytes = {"flash_attention_fwd": 2 * nq + 2 * nk + nl,
                  "flash_attention_dq": 4 * nq + 2 * nk + 2 * nl,
                  "flash_attention_dkv": 2 * nq + 4 * nk + 2 * nl}
        calls = {
            "flash_attention_fwd":
                lambda: fa.flash_attention(q, k, v, return_lse=True),
            "flash_attention_dq":
                lambda: fab.flash_attention_dq(q, k, v, o, do, lse),
            "flash_attention_dkv":
                lambda: fab.flash_attention_dkv(q, k, v, do, lse, delta)}
        k_ms = {n: time_ms(fn, 10, flush) for n, fn in calls.items()}
        plain_fwd = time_ms(lambda: attention_ref(q, k, v), 5, flush)
        plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, lse),
                            3, flush)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                  enable_gqa=True)

        lib_fwd = time_ms(sdpa, 10, flush)
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qg, kg, vg), do), 10, flush)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_dq": plain_bwd,
                 "flash_attention_dkv": plain_bwd}
        res[dtype] = {}
        for n in calls:
            t_ops = flops[n] / PEAK_FLOPS[dtype] * 1e3
            t_bytes = nbytes[n] / HBM_BYTES_PER_S * 1e3
            res[dtype][n] = {
                "ms": k_ms[n], "plain_ms": plain[n],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_fwd if n == "flash_attention_fwd" else None}
            print(f"[7] {n} {str(dtype):14s} B={b} H={h} K={kh} S={sq} "
                  f"D={d} causal: kernel_ms={k_ms[n]:.4f} "
                  f"plain_ms={plain[n]:.4f} bound_ms="
                  f"{res[dtype][n]['bound_ms']:.4f} (flops {flops[n]}, "
                  f"bytes {nbytes[n]}) [{card}]")
        print(f"[7] flash library yardstick {str(dtype):14s}: "
              f"scaled_dot_product_attention fwd_ms={lib_fwd:.4f} "
              f"fwd+bwd_ms={lib_fwd_bwd:.4f}; plain backward (dq, dk, dv "
              f"in one call) ms={plain_bwd:.4f} [{card}]")
        del q, k, v, do, o, lse, delta, qg, kg, vg
    return res


def phase_train_profile(tr, step_fn, card):
    """TRAIN_PROFILE_STEPS training steps of the main path's trainer timed
    untraced, then as many traced with ``torch.profiler``."""
    from repro_torch.data.pipeline import to_device
    batches = [to_device(tr.corpus.batch(1000 + i), "cuda")
               for i in range(TRAIN_PROFILE_STEPS)]

    def steps():
        for batch in batches:
            tr.params, tr.opt_state, _ = step_fn(tr.params, tr.opt_state,
                                                 batch)

    walls = []                                # the trainer is warm
    torch.cuda.synchronize()
    for batch in batches:
        t0 = time.perf_counter()
        tr.params, tr.opt_state, _ = step_fn(tr.params, tr.opt_state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        steps()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / TRAIN_PROFILE_STEPS
    kernels, busy, by_name = _profile_summary(prof, TRAIN_PROFILE_STEPS)
    total = sum(t for t, _ in by_name.values())
    fa_ms = {key: sum(t for n, (t, _) in by_name.items() if key in n)
             for key in ("fa_fwd_kernel", "fa_dq_kernel", "fa_dkv_kernel")}
    untraced = float(np.mean(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print("[8] train " + json.dumps({
        "card": card, "model": "smollm-135m (random weights, fp32 masters, "
        "bf16 compute)", "seq_len": FA_MAIN[3], "batch": FA_MAIN[0],
        "steps": TRAIN_PROFILE_STEPS,
        "step_wall_ms_untraced_mean": untraced,
        "step_wall_ms_untraced_p50": float(np.percentile(walls, 50)),
        "step_wall_ms_traced_mean": traced,
        "device_busy_ms_per_step": busy,
        "device_idle_share_untraced": 1 - busy / untraced,
        "device_idle_share_traced": 1 - busy / traced,
        "kernels_per_step": len(kernels) / TRAIN_PROFILE_STEPS,
        "flash_ms_per_step": {k: v / TRAIN_PROFILE_STEPS
                              for k, v in fa_ms.items()},
        "flash_share_of_kernel_time": sum(fa_ms.values()) / total,
        "top_kernels_ms_per_step": [
            {"name": n[:80], "ms": t / TRAIN_PROFILE_STEPS,
             "calls": c / TRAIN_PROFILE_STEPS} for n, (t, c) in top]}))


def build_report(build):
    """Print each kernel's registers and spills from nvcc's ptxas report."""
    for src in sorted(build.sources()):
        name, spill = None, ""
        for line in build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"\d+([a-z]+(?:_[a-z]+)*_kernel)"
                              r"I(f|13__nv_bfloat16)Li(\d+)E", m.group(1))
                dtype = k and ("float" if k.group(2) == "f" else "bf16")
                name = (f"{k.group(1)}<{dtype},{k.group(3)}>" if k
                        else m.group(1))
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "registers" in line:
                print(f"[2] ptxas {src}: {name}: "
                      f"{line.split(':', 1)[1].strip()}; {spill}")
                name = None

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    t0 = time.perf_counter()
    took = _build.build()
    print(f"[2] built {sorted(took)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: {took})")
    build_report(_build)

    gen = torch.Generator(device="cuda").manual_seed(0)
    pa_err = phase_kernels(pa, paged_attention_ref, gen)
    fa_err = phase_flash_kernels(gen)
    pa_launches, cfg, params = phase_main_path(card)
    check(all(n == 0 for n in _flash_counts().values()),
          "the serving path launched a flash-attention kernel")
    fa_launches, trainer, step_fn = phase_train(card)
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    timing = phase_timing(pa, paged_attention_ref, gen, card)
    fa_timing = phase_flash_timing(gen, card)
    phase_decode_profile(cfg, params, card)
    del params
    phase_train_profile(trainer, step_fn, card)

    k_ms, p_ms, bound = timing[torch.bfloat16]
    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
        "replaces": PA_REPLACES, "launches": pa_launches,
        "max_abs_err": pa_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None}]
    for name, replaces in FA_REPLACES.items():
        kernels.append({
            "name": name, "route": "cuda",
            "source": FA_SOURCE if name.endswith("fwd") else FA_BWD_SOURCE,
            "replaces": replaces, "launches": fa_launches[name],
            "max_abs_err": fa_err[name],
            **fa_timing[torch.bfloat16][name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
