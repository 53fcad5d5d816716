"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into the
git-ignored ``build/``, one ``nvcc`` per source, all at once), holds each
kernel against its plain PyTorch version on the card, drives the port's
main paths at full width with seeded random weights: requests served
through ``repro_torch.serve.engine.ServingEngine`` on smollm-135m and on
h2o-danube-3-4b (head_dim 120), the Coyote shell (``repro_torch.core``)
with its five apps and smollm-135m served from a vFPGA slot, training steps through
``repro_torch.train.loop.Trainer`` on smollm-135m, and dense-cache serving
(``prefill`` and ``decode_step`` of ``models/transformer.py``) of
mamba2-1.3b; checks the card against the CPU on the reduced models, times
the kernels and profiles a decode step, a training step, a mamba prefill
and a mamba decode step.  Phases, in order:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel, print the build seconds and each kernel's
     registers, shared memory and spills;
  3. kernels vs plain versions on the card (fp32 and bf16): paged
     attention with and without the split of rows over several blocks
     (G 1-10, D 32-128 with 80 and 120, pages of 16-256, a ragged table,
     empty rows, rows ending on a tile or a split, both decode shapes);
     the flash-attention forward, dq and dkv kernels (bf16 on the tensor
     cores, float32 on FMA) on the reference's test cases, head dims 32,
     64, 80, 120 and 128, h2o-danube's and the training shape, and
     ``mha_fused``'s gradient against autograd of the plain forward; the
     SSD scan (bf16 on the tensor cores, float32 on FMA) on the
     reference's cases, the reduced and the main mamba shapes, a ragged S
     and an initial state;
  4. serving main path: 24 requests through the engine at full width, bf16,
     every paged-attention call on ``pa_decode_kernel``;
 10. h2o-danube serving: 8 requests of 256-1024 prompt tokens, 32 new
     tokens each, through the engine at full width in bf16 (head_dim 120 on
     the paged kernel built for 128), likewise;
 11. the shell: ``Shell`` with all five services and four vFPGA slots on
     the card (its build allocating nothing); the transfer engine's
     word-granular (64 MiB), chunked and whole (256 MiB) uploads, each
     downloaded and compared; slot 0 ``lm_serving`` at full-width
     smollm-135m, bf16 (phase 4's weights and MMU), serving two tenants
     weighted 3:1, 8 prompts of 64-512 tokens each, 32 new tokens, while
     slot 2 is hot-swapped (hll -> vector_add -> hll), with every paged
     call on ``pa_decode_kernel`` and the billed decode I/O equal to the
     engine's; slot 1 AES (ECB over 64 MiB, CBC with 1 and 64 streams of
     256 blocks, FIPS-197), slot 2 HLL (2^24 items, 2^20 distinct), slot
     3 the NN (262,144 x 593 rows, streamed and staged), each against the
     CPU; ``reconfigure_shell`` dropping the sniffer, ``cold_restart``;
     reduced smollm fp32 through the app on the card and the CPU;
  5. training main path: 20 steps of ``Trainer`` at full width, sequence
     2048, batch 8, fp32 masters with bf16 compute, a checkpoint every 5
     steps and an injected failure at step 12 (one restart); its forward,
     dq and dkv launches all on the tensor-core kernels;
  9. mamba serving main path: 12 requests of full-width mamba2-1.3b, bf16
     (8 prompts of 2048 tokens, 4 of 1000), two ``prefill`` calls and 64
     greedy ``decode_step``s for each; then, with fp32 weights, decode
     after a 1000-token prefill against the prefill of 1001 tokens;
  6. card vs CPU on the reduced models, fp32: decode_step_paged, 3
     ``Trainer`` steps from the same weights (its forward, dq and dkv
     launches all on the float32 FMA kernels), mamba2 prefill and 8 decode
     steps;
  7. kernel timing at the main paths' shapes (median, p10 and p90), with
     each kernel's bound and a PyTorch library call as yardstick where one
     computes the same function (for flash attention also SDPA's backward
     alone); for paged attention also the h2o-danube decode shape, the
     profiler's device time per call, the wrapper's host time per call and
     a sweep of the split length and the ring depth;
  8. profiles: where a steady decode step (every slot full), a training
     step, a mamba prefill call and a mamba decode step spend their time
     (host wall untraced and traced, device busy time, the device's idle
     share, launches, the kernels that take the most device time).

Each main path runs with every kernel's launch count set to 0 just before
it and read just after it; each phase's number is printed at the start of
its lines (phases 10 and 11 run after phase 4, phase 9 after phase 5).  Any failed phase ends the script with a
non-zero exit and no result line.  The line before the last is a JSON
object describing each kernel; the last line is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import gc
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
# the kernel each dtype runs, by the kernels line's name
VARIANTS = {
    "paged_attention": {
        "bfloat16": "pa_decode_kernel (16-byte cp.async ring, a lane group "
                    "per token, splits merged by the row's last block)",
        "float32": "pa_decode_kernel (the same template, 4 floats a lane)"},
    "flash_attention_fwd": {"bfloat16": "fa_fwd_wgmma_kernel (wgmma, TMA)",
                            "float32": "fa_fwd_kernel (float32 FMA)"},
    "flash_attention_dq": {"bfloat16": "fa_dq_wgmma_kernel (wgmma, TMA)",
                           "float32": "fa_dq_kernel (float32 FMA)"},
    "flash_attention_dkv": {"bfloat16": "fa_dkv_wgmma_kernel (wgmma, TMA)",
                            "float32": "fa_dkv_kernel (float32 FMA)"},
    "ssd": {"bfloat16": "ssd_cb_kernel, ssd_state_kernel, ssd_pass_kernel, "
                        "ssd_scan_kernel (wgmma; float32 operands as bf16 "
                        "hi + lo)",
            "float32": "ssd_kernel (float32 FMA)"}}
# the paged-attention kernels by name, for the decode profile
PA_PROFILE_NAMES = sorted({n for v in VARIANTS["paged_attention"].values()
                           for n in re.findall(r"\w+_kernel", v)})
FA_REPLACES = {
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:36",
    "flash_attention_dq":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:48",
    "flash_attention_dkv":
        "src/repro/kernels/flash_attention/flash_attention_bwd.py:97"}
SSD_SOURCE = "src/repro_torch/csrc/ssd.cu"
SSD_REPLACES = "src/repro/kernels/ssd/ssd.py:34"
# (B, S, H, P, G, N, chunk): tests/test_kernels.py SSD_CASES, the reduced
# mamba2's shape, the main prefill shape and its ragged second batch
SSD_CASES = [(2, 128, 4, 64, 1, 32, 32), (1, 200, 8, 64, 2, 64, 64),
             (2, 256, 4, 32, 4, 16, 128), (2, 77, 8, 32, 1, 16, 32)]
SSD_MAIN = (8, 2048, 64, 64, 1, 128, 256)
SSD_RAGGED = (4, 1000, 64, 64, 1, 128, 256)
# SSD: atol 5e-4 (the reference's SSD tests) plus a relative term.  Both
# versions take the prefix sum cum of dt * A over a chunk in float32 in
# different orders; at L 256 |cum| reaches a few hundred, where float32
# keeps ~1e-5 absolute, so exp(cum_i - cum_j) and every y and state term
# differ by ~1e-4 of their value (rtol 2^-12).  y in bf16 is in addition
# one bf16 rounding (2^-9 of its value) from that float32 sum (rtol 2^-8).
# The bf16 tensor-core path splits each float32 operand into bf16 hi + lo
# (under 2^-16 of each term), which keeps these bounds
# (tests/test_torch_ssd.py emulates it; one bf16 rounding breaks them).
SSD_ATOL = 5e-4
SSD_RTOL = {torch.float32: 2.0 ** -12, torch.bfloat16: 2.0 ** -8}
MAMBA_PROMPTS = ((8, 2048), (4, 1000))    # (requests, prompt tokens)
MAMBA_DECODE_STEPS = 64
# decode after prefill vs prefill of one more token, full width, fp32:
# the kernel's chunked scan against the plain recurrence over 48 layers
MAMBA_CONSISTENCY_ATOL = 1e-3
MAMBA_PROFILE_STEPS = 16
# H100 SXM data sheet (NVIDIA), dense rates: HBM3 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; float32 outside the tensor cores 67 TFLOP/s (the
# float32 flash kernels compute float32 FMA: a float32 input held to atol
# 2e-5 cannot go through TF32)
HBM_BYTES_PER_S = 3.35e12
SPIN_CYCLES = 500_000        # phase 7: the card's wait for the host's call
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# flash-attention gradients: float32 atol 5e-4 (the reference's backward
# tests).  bf16, against the float32 plain version on the same bf16
# values: dq within ``ref.bf16_dq_bound`` and dk, dv within
# ``ref.bf16_dkv_bound``, the elementwise bounds implied by the tensor-core
# kernels' rounding of dS (dq) and of P and dS (dkv) to bf16 before their
# last products (derived beside them)
GRAD_ATOL = 5e-4
# (B, H, K, Sq, Sk, D, causal, window): tests/test_kernels.py FA_CASES and
# BWD_CASES, and the training path's shape
FA_CASES = [(2, 4, 2, 256, 256, 64, True, 0),
            (1, 8, 8, 128, 384, 128, True, 0),
            (2, 4, 1, 200, 200, 64, True, 0),
            (1, 4, 2, 256, 256, 64, True, 128),
            (1, 2, 2, 128, 256, 64, False, 0),
            (1, 4, 2, 128, 128, 64, True, 0),
            (2, 4, 2, 77, 77, 32, True, 0),         # D 32: the reduced model
            (2, 4, 2, 200, 200, 80, True, 0),       # D 80: zamba2's block
            (1, 4, 1, 130, 130, 120, True, 64),     # D 120, window
            (2, 32, 8, 2048, 2048, 120, True, 0)]   # h2o-danube-3-4b
BWD_CASES = [(1, 4, 2, 128, 128, 64, True, 0),
             (2, 2, 1, 96, 160, 64, True, 0),
             (1, 4, 4, 128, 128, 64, False, 0),
             (1, 2, 2, 128, 128, 64, True, 64),
             (1, 2, 1, 100, 100, 128, True, 0),     # D 128
             (2, 4, 2, 77, 77, 32, True, 0),        # D 32
             (2, 4, 2, 200, 200, 80, True, 0),      # D 80
             (1, 4, 1, 130, 130, 120, True, 64),    # D 120, window
             (2, 32, 8, 2048, 2048, 120, True, 0)]  # h2o-danube-3-4b
FA_MAIN = (8, 9, 3, 2048, 2048, 64, True, 0)
TRAIN_STEPS, TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 20, 12, 5
TRAIN_PROFILE_STEPS = 5
# (B, H, K, D, page, maxp, n_pages) from tests/test_kernels.py PA_CASES
PA_CASES = [(2, 8, 2, 64, 128, 4, 16), (3, 4, 4, 128, 64, 6, 32),
            (1, 16, 8, 64, 256, 3, 8),
            (2, 8, 2, 80, 16, 9, 40),        # D 80: zamba2's shared block
            (8, 32, 8, 120, 16, 64, 600)]    # D 120: h2o-danube-3-4b
MAIN_SHAPE = (16, 9, 3, 64, 16, 64, 2048)
# phase 7: h2o-danube-3-4b's decode (phase 10's engine: 8 rows, maxp 66 for
# max_len 1056), rows of 256-1056 tokens
H2O_SHAPE = (8, 32, 8, 120, 16, 66, 1024)
# phase 7's sweep of the paged kernel's split and ring depth (both shapes)
PA_SWEEP_PAGES = (2, 4, 8, 16, 32, 64)
PA_SWEEP_STAGES = (1, 2, 3, 4, 6)
PROFILE_STEPS = 32
# phase 10: full-width h2o-danube-3-4b (head_dim 120) through the engine
H2O_REQUESTS, H2O_PROMPT, H2O_NEW_TOKENS = 8, (256, 1024), 32
# phase 11: the shell on the card.  Slot 0 serves two tenants (3:1) of
# SHELL_REQUESTS prompts each; AES over 64 MiB (ECB) and 64 streams of 256
# blocks (CBC); HLL over 2^24 items of 2^20 distinct values; the NN on
# 262,144 rows of 593 features
SHELL_REQUESTS, SHELL_PROMPT, SHELL_NEW_TOKENS = 8, (64, 512), 32
AES_ECB_BYTES, AES_PREFIX_BYTES = 64 << 20, 1 << 20
AES_CBC_STREAMS, AES_CBC_BLOCKS = 64, 256
HLL_ITEMS, HLL_DISTINCT, HLL_PREFIX = 1 << 24, 1 << 20, 1 << 20
NN_ROWS, NN_BATCH = 262_144, 1024
SHELL_BATCH = 4
SHELL_LEN = SHELL_PROMPT[1] + SHELL_NEW_TOKENS
SHELL_SHAPE = (SHELL_BATCH, 9, 3, 64, 16, -(-SHELL_LEN // 16), 2048)


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
    # G 8 at D 128 (qwen2, chameleon); G 10 (two blocks of heads)
    cases.append(("g8", (2, 16, 2, 128, 16, 20, 64), [300, 77], None))
    cases.append(("g10", (2, 20, 2, 64, 16, 12, 32), [190, 0], None))
    # rows ending on a tile (32 tokens), on a split (8 pages) and on two
    cases.append(("edges", (4, 9, 3, 64, 16, 24, 128), [32, 128, 256, 0],
                  None))
    # enough blocks to fill the card without splitting rows: one pass
    cases.append(("wide", (192, 9, 3, 64, 16, 8, 2048),
                  main_lens(192, 16, 8), None))
    cases.append(("main", MAIN_SHAPE, main_lens(16, 16, 64), None))
    # phase 11's slot-0 engine (4 rows, maxp 34 for max_len 544): one live
    # row at the longest and at a mid-range length, three rows empty
    cases.append(("shell", SHELL_SHAPE, [SHELL_LEN, 0, 0, 0], None))
    cases.append(("shell2", SHELL_SHAPE, [0, 0, 301, 0], None))
    cases.append(("h2o", H2O_SHAPE, h2o_lens(), None))
    main_err = None
    for name, shape, lens, tables in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tab, ln = pa_inputs(shape, lens, dtype, gen, tables)
            out = pa.paged_attention(q, kp, vp, tab, ln)
            want = ref(q.float(), kp.float(), vp.float(), tab, ln)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} non-finite")
            check(all(bool((out[i] == 0).all())
                      for i, n in enumerate(lens) if n == 0),
                  f"{name}: an empty row is not exactly 0")
            err = float((out.float() - want).abs().max())
            tol = ATOL[dtype]
            pps = pa.plan(shape[0], shape[1], shape[2], shape[5], shape[4],
                          _sms())
            print(f"[3] {name:6s} {str(dtype):14s} G={shape[1] // shape[2]}"
                  f" D={shape[3]} page={shape[4]} pages_per_split={pps} "
                  f"splits={-(-shape[5] // pps):2d} max_abs_err={err:.3e} "
                  f"atol={tol:g}")
            check(err <= tol, f"kernel vs plain {name} {dtype}: {err}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = err
    return main_err


def _sms():
    return torch.cuda.get_device_properties(0).multi_processor_count


def h2o_lens():
    """Phase 7's h2o-danube rows: 256-1056 tokens, seeded."""
    rs = np.random.RandomState(11)
    return [int(x) for x in rs.randint(256, 1057, size=H2O_SHAPE[0])]


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
        "pa_launches": launches, "pa_kernel": "pa_decode_kernel",
    }
    print("[4] " + json.dumps(line))
    return launches, cfg, params


def phase_h2o_serving(card):
    """Full-width h2o-danube-3-4b in bf16 through ``ServingEngine``: its
    head_dim of 120 runs on the paged kernel built for 128.  H2O_REQUESTS
    requests of 256-1024 prompt tokens and H2O_NEW_TOKENS new tokens each,
    half greedy, half sampled.  Returns its paged-attention launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.services.mmu import MMU, MMUConfig
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.engine import ServingEngine

    cfg = get_config("h2o-danube-3-4b")
    check(cfg.head_dim == 120, f"h2o-danube head_dim {cfg.head_dim}")
    params = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(3), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    max_len = H2O_PROMPT[1] + H2O_NEW_TOKENS

    def engine(n_pages):
        mmu = MMU(MMUConfig(page_size=16, n_pages=n_pages))
        return mmu, ServingEngine(cfg, params, mmu, max_batch=H2O_REQUESTS,
                                  max_len=max_len, prefill_chunk=256,
                                  device="cuda")

    _, warm = engine(256)              # warm-up: cuBLAS, the kernel load
    warm.submit(list(range(3, 300)), max_new_tokens=4)
    warm.run()
    del warm
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, cfg.vocab_size, size=int(rs.randint(
        H2O_PROMPT[0], H2O_PROMPT[1] + 1))).tolist()
        for _ in range(H2O_REQUESTS)]
    mmu, eng = engine(2048)            # 2048 pages of 16: 3.77 GB of KV
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    for i, prompt in enumerate(prompts):
        eng.submit(prompt, max_new_tokens=H2O_NEW_TOKENS,
                   **({"temperature": 0.8} if i % 2 else {}))
    stats = eng.run()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(stats["completed"] == H2O_REQUESTS,
          f"h2o completed {stats['completed']}/{H2O_REQUESTS}")
    check(mmu.utilization()["pages_used"] == 0, "h2o pages leaked")
    for r in eng.completed:
        check(len(r.out_tokens) == H2O_NEW_TOKENS,
              f"h2o rid {r.rid} has {len(r.out_tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"h2o rid {r.rid} token outside the vocabulary")
    check(launches == cfg.n_layers * eng.steps,
          f"h2o LAUNCHES {launches} != {cfg.n_layers} x {eng.steps} steps")
    check(all(n == 0 for n in _flash_counts().values())
          and _ssd_count() == 0,
          "the h2o serving path launched a flash or SSD kernel")
    st = np.asarray(eng.decode_step_times) * 1e3
    print("[10] " + json.dumps({
        "card": card, "model": "h2o-danube-3-4b (random weights, bf16)",
        "params": n_params, "head_dim": cfg.head_dim,
        "requests": H2O_REQUESTS,
        "prompt_tokens": [len(p) for p in prompts],
        "decode_steps": eng.steps, "tokens": stats["tokens"],
        "wall_s": stats["wall_s"], "tokens_per_s": stats["tokens_per_s"],
        "decode_step_ms_p50": float(np.percentile(st, 50)),
        "decode_step_ms_p90": float(np.percentile(st, 90)),
        "prefill_tokens_per_s": eng.prefill_computed / eng.prefill_s,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "pa_launches": launches, "pa_kernel": "pa_decode_kernel",
        "first_tokens": [r.out_tokens[:6] for r in eng.completed[:2]]}))
    del eng, mmu, params
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------- shell
def _gbps(nbytes, seconds):
    return nbytes / seconds / 1e9


def _timed(fn):
    """(fn(), host seconds); the card is idle before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _flush():
    """A buffer larger than the 50 MB L2, zeroed before each timed call."""
    return torch.empty(256 << 20, dtype=torch.uint8, device="cuda")


def _shell_services():
    from repro_torch.core.services import (AESConfig, CollectiveConfig,
                                           CompressionConfig, MMUConfig,
                                           SnifferConfig)
    return {"mmu": MMUConfig(page_size=16, n_pages=2048),
            "encryption": AESConfig(), "compression": CompressionConfig(),
            "collectives": CollectiveConfig(), "sniffer": SnifferConfig()}


def _transfer_engine(eng, out):
    """Table 2 analogue: word-granular upload of 64 MiB, chunked and
    whole uploads of 256 MiB, each downloaded and compared."""
    rs = np.random.RandomState(21)
    for path, nbytes in (("word_granular", 64 << 20), ("chunked", 256 << 20),
                         ("whole", 256 << 20)):
        src = np.frombuffer(bytearray(rs.bytes(nbytes)), np.uint8)
        fn = {"word_granular": eng.upload_word_granular,
              "chunked": eng.upload, "whole": eng.upload_whole}[path]
        fn(src[:16 << 20])          # warm-up: the pinned ring, the context
        dev, st = fn(src)
        back, _ = eng.download(dev)
        check(np.array_equal(back.reshape(-1), src),
              f"transfer engine {path}: download differs from the source")
        out[f"upload_{path}_gbps"] = _gbps(nbytes, st.seconds)
        out[f"upload_{path}_chunks"] = st.chunks
        del dev, back


def _serve_two_tenants(shell, cfg, out):
    """Slot 0: two tenants (3:1) submit SHELL_REQUESTS prompts each
    through slot 0's port; slot 2 is hot-swapped (hll -> vector_add ->
    hll) while they are in flight."""
    from repro_torch.apps.hll import make_hll_artifact
    from repro_torch.apps.lm_serving import CSR_MAX_NEW_TOKENS
    from repro_torch.apps.vector_add import make_vector_add_artifact
    from repro_torch.core import Invocation, Oper, SgEntry
    from repro_torch.core.interfaces import Packet
    from repro_torch.kernels.paged_attention import paged_attention as pa

    port = shell.attach(0)
    shell.vfpgas[0].iface.csr.set_csr(SHELL_NEW_TOKENS, CSR_MAX_NEW_TOKENS)

    def submit(prompt, tenant, stream):
        inv = Invocation.from_sg(SgEntry(src=prompt, length=prompt.nbytes,
                                         src_stream=stream,
                                         opcode=Oper.KERNEL))
        inv.tenant = tenant
        return port.submit(inv)

    # warm-up: the engine (its KV pools), cuBLAS and the kernel library
    check(submit(np.arange(3, 40, dtype=np.int32), "gold", 0).result(
        timeout=300).ok, "slot 0 warm-up request failed")
    eng = shell.engines[0]
    rs = np.random.RandomState(22)
    prompts = [(t, rs.randint(1, cfg.vocab_size, size=int(rs.randint(
        SHELL_PROMPT[0], SHELL_PROMPT[1] + 1))).astype(np.int32))
        for _ in range(SHELL_REQUESTS) for t in ("gold", "bronze")]
    sched = shell.scheduler
    bytes0 = {t: s["bytes"] for t, s in sched.stats()["tenants"].items()}
    io0, steps0, done0 = eng.io_bytes, eng.steps, len(eng.completed)
    _zero_counts()
    t_sub, futs = [], []
    for tenant, prompt in prompts:
        t_sub.append(time.perf_counter())
        futs.append(submit(prompt, tenant, 0 if tenant == "gold" else 1))

    # hot-swap slot 2 under slot 0's traffic
    port2 = shell.attach(2)
    swaps = []
    for art in (make_vector_add_artifact(), make_hll_artifact()):
        check(not all(f.done() for f in futs),
              "slot 0's invocations finished before the hot-swap")
        st = shell.reconfigure(2, art)
        swaps.append({"app": art.name, "total_s": st["total_s"],
                      "drain_s": st["drain_s"], "replayed": st["replayed"]})
        if art.name == "vector_add":
            iface = shell.vfpgas[2].iface
            a, b = np.arange(8, dtype=np.float32), np.full(8, 2, np.float32)
            for i, v in enumerate((a, b)):
                iface.host_in[i].push(Packet(tid=0, seq_no=0, payload=v,
                                             nbytes=v.nbytes, last=True))
            comp = port2.submit(Invocation.from_sg(SgEntry(
                src=None, length=a.nbytes, opcode=Oper.KERNEL))).result(60)
            check(comp.ok and np.array_equal(comp.result, a + b),
                  "vector_add on the hot-swapped slot 2")
    comps = [f.result(timeout=600) for f in futs]
    eng.flush_io(timeout=60, strict=True)
    shell.drain()
    torch.cuda.synchronize()
    launches = pa.LAUNCHES
    check(all(c.ok for c in comps),
          f"slot 0 failures: {[c.result for c in comps if not c.ok][:2]}")
    new = eng.completed[done0:]
    check(len(new) == len(prompts) and len({r.rid for r in new}) == len(new),
          f"slot 0 completed {len(new)} distinct requests, not "
          f"{len(prompts)}: a completion was lost or duplicated")
    pst = port.stats()
    check(pst["submitted"] == pst["completed"],
          f"slot 0 port submitted {pst['submitted']} completed "
          f"{pst['completed']}")
    by_list = {id(r.out_tokens): r for r in new}
    steps = eng.steps - steps0
    check(launches == cfg.n_layers * steps,
          f"slot 0 LAUNCHES {launches} != {cfg.n_layers} x {steps} steps")
    check(all(n == 0 for n in _flash_counts().values())
          and _ssd_count() == 0, "slot 0 launched a flash or SSD kernel")
    lat = {"gold": ([], []), "bronze": ([], [])}
    for (tenant, prompt), t0, c in zip(prompts, t_sub, comps):
        r = by_list[id(c.result)]
        check(r.prompt == prompt.tolist(), "a completion carries another "
              "request's tokens")
        check(len(r.out_tokens) == SHELL_NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"rid {r.rid}: {len(r.out_tokens)} tokens or one outside "
              f"the vocabulary")
        lat[tenant][0].append(r.t_first_token - t0)
        lat[tenant][1].append((r.t_done - r.t_first_token)
                              / (len(r.out_tokens) - 1))
    stats = sched.stats()["tenants"]
    billed = {t: s["bytes"] - bytes0.get(t, 0) for t, s in stats.items()}
    io = eng.io_bytes - io0
    check(billed[eng.tenant or "tenant0"] == io,
          f"billed decode I/O {billed} != engine io_bytes {io}")
    for t in ("gold", "bronze"):
        want = sum(p.nbytes for tt, p in prompts if tt == t)
        check(billed[t] == want, f"tenant {t} billed {billed[t]}, its "
              f"prompts are {want} bytes")
    total = sum(billed.values())
    out.update({
        "requests": len(prompts), "decode_steps": steps,
        "pa_launches": launches, "engine_io_bytes": io,
        "billed_bytes": billed,
        "byte_shares": {t: b / total for t, b in billed.items()},
        "ttft_p50_ms": {t: float(np.percentile(v[0], 50) * 1e3)
                        for t, v in lat.items()},
        "tpot_p50_ms": {t: float(np.percentile(v[1], 50) * 1e3)
                        for t, v in lat.items()},
        "decode_step_ms_p50": float(np.percentile(
            eng.decode_step_times[-steps:], 50) * 1e3),
        "hot_swaps_slot2": swaps})


def _aes_slot(shell, out):
    from repro_torch.apps.aes import make_aes_artifact
    from repro_torch.core import Invocation, Oper, SgEntry
    from repro_torch.core.services import encryption as E

    rs = np.random.RandomState(23)
    data = np.frombuffer(bytearray(rs.bytes(AES_ECB_BYTES)), np.uint8)
    port = shell.attach(1)
    key = np.arange(16, dtype=np.uint8)             # the CSR default key
    rk_cpu = torch.from_numpy(E.expand_key(key))
    shell.vfpgas[1].invoke_kernel(data[:AES_PREFIX_BYTES])     # warm-up
    app_s = _timed(lambda: shell.vfpgas[1].invoke_kernel(data))[1]
    comp, ecb_s = _timed(lambda: port.submit(Invocation.from_sg(SgEntry(
        src=data, length=data.size, opcode=Oper.KERNEL))).result(300))
    check(comp.ok, f"AES ECB on slot 1: {comp.result}")
    pre = AES_PREFIX_BYTES
    want = E.aes_ecb(torch.from_numpy(data[:pre].reshape(-1, 16).copy()),
                     rk_cpu).numpy().reshape(-1)
    check(np.array_equal(comp.result[:pre], want),
          "AES ECB on the card differs from the CPU on the 1 MiB prefix")
    blocks = torch.from_numpy(data.reshape(-1, 16)).cuda()
    rk = rk_cpu.cuda()
    dev_ms = time_ms(lambda: E.aes_ecb(blocks, rk), 5, _flush())[0]
    fips_key = np.frombuffer(bytes.fromhex(
        "2b7e151628aed2a6abf7158809cf4f3c"), np.uint8).copy()
    pt = torch.from_numpy(np.frombuffer(bytes.fromhex(
        "3243f6a8885a308d313198a2e0370734"), np.uint8).copy()).cuda()
    ct = E.aes_ecb(pt[None], torch.from_numpy(
        E.expand_key(fips_key)).cuda())[0].cpu().numpy()
    check(ct.tobytes().hex() == "3925841d02dc09fbdc118597196a0b32",
          f"FIPS-197 Appendix B on the card gives {ct.tobytes().hex()}")
    del blocks
    st = shell.reconfigure(1, make_aes_artifact("cbc"))
    out["app_reconfigure_s"]["aes_ecb->aes_cbc"] = st["total_s"]
    vf = shell.vfpgas[1]
    cbc = {}
    for streams in (1, AES_CBC_STREAMS):
        buf = np.frombuffer(bytearray(rs.bytes(streams * AES_CBC_BLOCKS * 16)),
                            np.uint8)
        vf.invoke_kernel(buf, streams)              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = vf.invoke_kernel(buf, streams)
        secs = time.perf_counter() - t0
        blk = torch.from_numpy(buf.reshape(streams, -1, 16).copy())
        want = E.aes_cbc_multistream(
            blk, torch.zeros((streams, 16), dtype=torch.uint8),
            rk_cpu).numpy().reshape(-1)
        check(np.array_equal(got, want),
              f"AES CBC x{streams} on the card differs from the CPU")
        cbc[streams] = (buf.size, secs)
    out.update({
        "aes_ecb_bytes": data.size, "aes_ecb_port_gbps": _gbps(
            data.size, ecb_s), "aes_ecb_app_gbps": _gbps(data.size, app_s),
        "aes_ecb_device_gbps": _gbps(
            data.size, dev_ms / 1e3),
        "aes_cbc_blocks_per_stream": AES_CBC_BLOCKS,
        "aes_cbc_x1_gbps": _gbps(*cbc[1]), "aes_cbc_x1_s": cbc[1][1],
        f"aes_cbc_x{AES_CBC_STREAMS}_gbps": _gbps(*cbc[AES_CBC_STREAMS]),
        f"aes_cbc_x{AES_CBC_STREAMS}_s": cbc[AES_CBC_STREAMS][1]})


def _hll_items():
    """HLL_ITEMS items over exactly HLL_DISTINCT distinct 32-bit values
    (an odd multiplier is a bijection modulo 2^32), shuffled."""
    rs = np.random.RandomState(24)
    base = ((np.arange(HLL_DISTINCT, dtype=np.uint64) * 2654435761 + 12345)
            % (1 << 32)).astype(np.uint32)
    return np.tile(base, HLL_ITEMS // HLL_DISTINCT)[
        rs.permutation(HLL_ITEMS)]


def _hll_slot(shell, out):
    from repro_torch.apps import hll as H
    from repro_torch.core import Invocation, Oper, SgEntry

    items = _hll_items()
    port = shell.attach(2)
    src = items.view(np.uint8)
    shell.vfpgas[2].invoke_kernel(src[:HLL_PREFIX * 4])        # warm-up
    app_s = _timed(lambda: shell.vfpgas[2].invoke_kernel(src))[1]
    comp, secs = _timed(lambda: port.submit(Invocation.from_sg(SgEntry(
        src=src, length=src.size, opcode=Oper.KERNEL))).result(300))
    check(comp.ok, f"HLL on slot 2: {comp.result}")
    err = abs(comp.result - HLL_DISTINCT) / HLL_DISTINCT
    bound = 3 * 1.04 / math.sqrt(4096)
    check(err <= bound, f"HLL estimate {comp.result} is {err:.4f} off "
          f"{HLL_DISTINCT} (bound {bound:.4f})")
    pre = torch.from_numpy(items[:HLL_PREFIX].view(np.int32).copy())
    check(torch.equal(H.hll_sketch(pre.cuda()).cpu(), H.hll_sketch(pre)),
          "HLL registers on the card differ from the CPU's on the prefix")
    dev_items = torch.from_numpy(items.view(np.int32).copy()).cuda()
    dev_ms = time_ms(lambda: H.hll_sketch(dev_items), 5, _flush())[0]
    del dev_items
    out.update({"hll_items": HLL_ITEMS, "hll_distinct": HLL_DISTINCT,
                "hll_estimate": comp.result, "hll_rel_err": err,
                "hll_port_items_per_s": HLL_ITEMS / secs,
                "hll_app_items_per_s": HLL_ITEMS / app_s,
                "hll_device_items_per_s": HLL_ITEMS / (dev_ms / 1e3)})


def _nn_slot(shell, overlay, out):
    from repro_torch.apps.nn_inference import StagedCopyBaseline, mlp_apply

    x = torch.randn((NN_ROWS, 593), generator=torch.Generator().manual_seed(
        25)).numpy()
    want = mlp_apply(overlay.params, torch.from_numpy(x)).numpy()
    overlay.predict(x[:NN_BATCH * 4], batch_size=NN_BATCH)    # warm-up
    got_app, app_s = _timed(lambda: shell.vfpgas[overlay.slot].invoke_kernel(x))
    got, stream_s = _timed(lambda: overlay.predict(x, batch_size=NN_BATCH))
    check(np.array_equal(got_app, got), "NN: the app's stream loop and the "
          "port's predict differ")
    staged = StagedCopyBaseline(overlay.params, device="cuda")
    staged.predict(x[:NN_BATCH * 4], batch_size=NN_BATCH)
    t0 = time.perf_counter()
    got_staged = staged.predict(x, batch_size=NN_BATCH)
    staged_s = time.perf_counter() - t0
    for name, y in (("streamed", got), ("staged", got_staged)):
        err = float(np.abs(y - want).max())
        check(y.shape == (NN_ROWS, 1) and err <= 1e-4,
              f"NN {name} on the card vs the CPU: max_abs_err {err}")
    out.update({"nn_rows": NN_ROWS, "nn_batch": NN_BATCH,
                "nn_streamed_rows_per_s": NN_ROWS / stream_s,
                "nn_streamed_app_rows_per_s": NN_ROWS / app_s,
                "nn_staged_rows_per_s": NN_ROWS / staged_s,
                "nn_max_abs_err": float(np.abs(got - want).max())})


def _reduced_app_card_vs_cpu():
    """Reduced smollm-135m fp32 through the lm_serving app on a one-slot
    shell on the card and on the CPU: identical greedy tokens."""
    from repro_torch.apps.lm_serving import (CSR_MAX_NEW_TOKENS,
                                             make_lm_serving_artifact)
    from repro_torch.configs import get_config
    from repro_torch.core import Oper, SgEntry, Shell, ShellConfig
    from repro_torch.core.services import MMUConfig
    from repro_torch.models.transformer import init_params

    cfg = get_config("smollm-135m").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(26),
                         dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(26)
    prompts = [rs.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (9, 40, 17)]
    runs = {}
    for dev in ("cpu", "cuda"):
        shell = Shell(ShellConfig.make(services={
            "mmu": MMUConfig(page_size=16, n_pages=64)}, n_vfpgas=1),
            device=dev)
        shell.build()
        shell.load_app(0, make_lm_serving_artifact(
            cfg, _to_device(params, dev), max_len=96))
        ct = shell.attach_thread(0, pid=7)
        ct.setCSR(12, CSR_MAX_NEW_TOKENS)
        runs[dev] = []
        for pr in prompts:
            comp = ct.invoke(Oper.KERNEL, SgEntry(src=pr, length=pr.nbytes),
                             timeout=120)
            check(comp.ok, f"reduced lm_serving on {dev}: {comp.result}")
            runs[dev].append(list(comp.result))
        shell.close()
    check(runs["cpu"] == runs["cuda"],
          f"reduced lm_serving tokens differ: {runs}")
    return runs["cuda"]


def _to_device(tree, dev):
    return ({k: _to_device(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


def phase_shell(card, cfg, params):
    """Phase 11: the Coyote v2 shell on the card.  Builds
    ``Shell(services=<all five>, n_vfpgas=4)``, checks the transfer
    engine, loads lm_serving (full-width smollm-135m, bf16), AES, HLL and
    the NN into slots 0-3, serves two weighted tenants from slot 0 while
    slot 2 is hot-swapped, runs each app against the CPU, reconfigures
    the shell and cold-restarts it.  Returns the paged-attention launches
    of slot 0's run."""
    from repro_torch.apps.aes import make_aes_artifact
    from repro_torch.apps.hll import make_hll_artifact
    from repro_torch.apps.lm_serving import make_lm_serving_artifact
    from repro_torch.apps.nn_inference import CoyoteOverlay
    from repro_torch.core import Invocation, Oper, SgEntry, Shell, ShellConfig

    t_phase = time.perf_counter()
    out = {"card": card, "app_reconfigure_s": {}}
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    shell = Shell(ShellConfig.make(services=_shell_services(), n_vfpgas=4),
                  device="cuda")
    report = shell.build()
    out["build_s"] = time.perf_counter() - t0
    out["build_components"] = report.components
    check(torch.cuda.max_memory_allocated() <= mem0,
          f"the shell's build allocated device memory: peak "
          f"{torch.cuda.max_memory_allocated()} > {mem0} bytes")
    check(all(c["compile_s"] == 0.0 for c in report.components.values()),
          "a build reported compile seconds")
    _transfer_engine(shell.static.engine, out)

    shell.register_tenant("gold", 3.0)
    shell.register_tenant("bronze", 1.0)
    for slot, art in ((0, make_lm_serving_artifact(
            cfg, params, max_batch=SHELL_BATCH, max_len=SHELL_LEN)),
            (1, make_aes_artifact("ecb")),
            (2, make_hll_artifact())):
        out["app_reconfigure_s"][art.name] = shell.load_app(
            slot, art)["total_s"]
    overlay = CoyoteOverlay(shell, slot=3, seed=0)
    out["app_reconfigure_s"]["nn_inference"] = overlay.program_fpga(
        warm_batch=NN_BATCH)["total_s"]
    sniffer = shell.services.get("sniffer")
    sniffer.start()

    _serve_two_tenants(shell, cfg, out)
    launches = out["pa_launches"]
    _aes_slot(shell, out)
    _hll_slot(shell, out)
    _nn_slot(shell, overlay, out)
    out["sniffer_records"] = len(sniffer.to_records())
    check(out["sniffer_records"] > 0, "the sniffer captured nothing")

    t0 = time.perf_counter()
    services = _shell_services()
    del services["sniffer"]
    st = shell.reconfigure_shell(ShellConfig.make(services=services,
                                                  n_vfpgas=4))
    out["shell_reconfigure_s"] = time.perf_counter() - t0
    out["shell_reconfigure_kernel_s"] = st["kernel_s"]
    check("sniffer" not in shell.services.names()
          and all(vf.app is not None for vf in shell.vfpgas),
          "reconfigure_shell did not drop the sniffer or lost an app")
    r = shell.cold_restart()
    out["cold_restart_s"] = r["total_s"]
    check([vf.app.name for vf in shell.vfpgas]
          == ["lm_serving", "aes_cbc", "hll", "nn_inference"],
          "cold_restart did not reload every slot")
    items = _hll_items()[:1 << 20]
    comp = shell.attach(2).submit(Invocation.from_sg(SgEntry(
        src=items.view(np.uint8), length=items.nbytes,
        opcode=Oper.KERNEL))).result(120)
    check(comp.ok and comp.result > 0, "HLL after cold_restart")
    shell.close()
    out["reduced_fp32_tokens"] = _reduced_app_card_vs_cpu()
    out["phase_s"] = time.perf_counter() - t_phase
    print("[11] " + json.dumps(out))
    del shell, overlay
    torch.cuda.empty_cache()
    return launches


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
        _zero_counts()
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
    from repro_torch.kernels.paged_attention import paged_attention as pa
    launches = pa.LAUNCHES                  # the card run's, float32
    check(launches == 8 * cfg.n_layers, f"the float32 decode launched "
          f"pa_decode_kernel {launches} times, not {8 * cfg.n_layers}")
    (ct, cp), (gt, gp) = runs["cpu"], runs["cuda"]
    live = [i for i, n in enumerate(plens) if n]
    for s, (a, g) in enumerate(zip(ct, gt)):
        check(bool((a[live] == g[live]).all()),
              f"greedy tokens differ at step {s}: {a} vs {g}")
    err = max(float((cp[k] - gp[k]).abs().max()) for k in ("k", "v"))
    print(f"[6] reduced smollm fp32, 8 teacher-forced decode steps: tokens "
          f"identical, pool max_abs_err={err:.3e} atol=1e-4; float32 ran "
          f"pa_decode_kernel {launches} times")
    check(err <= 1e-4, f"pools differ by {err}")


def time_ms(fn, reps, flush):
    """CUDA-event times of ``fn`` with L2 flushed before each call, after 3
    warm-up calls: (median, p10, p90) in ms.  The card spins for about a
    quarter of a millisecond between the flush and the first event, so the
    host has enqueued ``fn`` before the card reaches it: a slow host does
    not show up as device time."""
    times = []
    for _ in range(reps + 3):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(z))
    t = np.asarray(times[3:])
    return (float(np.median(t)), float(np.percentile(t, 10)),
            float(np.percentile(t, 90)))


def spread(t) -> str:
    """A (median, p10, p90) triple as printed by phase 7."""
    return f"{t[0]:.4f} (p10 {t[1]:.4f}, p90 {t[2]:.4f})"


def pa_device_ms(fn, reps, flush):
    """Per call, the device time of the paged-attention kernels from a
    ``torch.profiler`` trace of ``reps`` calls, each after an L2 flush:
    {kernel name: median ms} and their sum (each runs once a call)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    per = {n: [] for n in PA_PROFILE_NAMES}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in PA_PROFILE_NAMES:
            if n in e.name:
                per[n].append((e.time_range.end - e.time_range.start) / 1e3)
    # the tracer may miss a call's kernels at its start: half must be there
    check(len(per["pa_decode_kernel"]) >= reps // 2,
          f"profile of {reps} paged calls holds "
          f"{len(per['pa_decode_kernel'])} pa_decode_kernel launches")
    medians = {n: float(np.median(v)) for n, v in per.items() if v}
    return medians, sum(medians.values())


def host_us(fn, n=100):
    """Host microseconds per call of ``fn`` over ``n`` calls, no sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase_timing(pa, ref, gen, card):
    """The paged kernel at the smollm decode shape (bf16 and float32) and
    at h2o-danube's (bf16), L2 flushed before each call: CUDA-event time,
    the kernels' device time from the profiler, the wrapper's host time,
    the plain version's time and the byte bound; then, in bf16 at both
    shapes, a sweep of pages_per_split and the ring depth.  Returns the
    timing of each (shape name, dtype)."""
    launches = pa.LAUNCHES            # timing launches are not main-path
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for name, shape, lens, dtypes in (
            ("main", MAIN_SHAPE, main_lens(16, 16, 64),
             (torch.float32, torch.bfloat16)),
            ("h2o", H2O_SHAPE, h2o_lens(), (torch.bfloat16,))):
        b, h, kh, d, page, maxp, n_pages = shape
        for dtype in dtypes:
            q, kp, vp, tab, ln = pa_inputs(shape, lens, dtype, gen)
            s = q.element_size()
            nbytes = (2 * q.numel() * s + sum(lens) * kh * d * 2 * s
                      + tab.numel() * 4 + ln.numel() * 4)

            def call():
                return pa.paged_attention(q, kp, vp, tab, ln)

            for _ in range(200):           # warm: clocks up, plan cached
                call()
            k_ms = time_ms(call, 50, flush)
            dev, dev_ms = pa_device_ms(call, 30, flush)
            h_us = host_us(call)
            p_ms = time_ms(lambda: ref(q, kp, vp, tab, ln), 20, flush)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            res[(name, dtype)] = (k_ms[0], p_ms[0], bound)
            pps = pa.plan(b, h, kh, maxp, page, _sms())
            print(f"[7] paged_attention {name} {str(dtype):14s} B={b} H={h} "
                  f"K={kh} D={d} page={page} maxp={maxp} "
                  f"sum(lens)={sum(lens)} pages_per_split={pps} splits="
                  f"{-(-maxp // pps)} stages={pa.STAGES}: "
                  f"kernel_ms={spread(k_ms)} device_ms={dev_ms:.4f} "
                  f"(profiler, by kernel {json.dumps(dev)}) host_us_per_call="
                  f"{h_us:.1f} plain_ms={spread(p_ms)} bound_ms={bound:.4f} "
                  f"(bytes {nbytes}; {bound / k_ms[0]:.1%} of the bound) "
                  f"[{card}]")
            if dtype == torch.bfloat16:
                for pps_s in PA_SWEEP_PAGES:
                    row = []
                    for st in PA_SWEEP_STAGES:
                        t = time_ms(lambda: pa.paged_attention(
                            q, kp, vp, tab, ln, pages_per_split=pps_s,
                            stages=st), 20, flush)
                        row.append(f"stages {st}: {t[0]:.4f}")
                    print(f"[7] paged sweep bf16 {name} pages_per_split="
                          f"{pps_s} (splits {-(-maxp // pps_s)}): "
                          + ", ".join(row) + f" ms [{card}]")
            del q, kp, vp, tab, ln
    pa.LAUNCHES = launches
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
                if any(k in n for k in PA_PROFILE_NAMES))
    check(pa_ms > 0, f"profile: none of the paged-attention kernels "
          f"{PA_PROFILE_NAMES} is in the decode trace")
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
        "paged_attention_ms_per_step": pa_ms / PROFILE_STEPS,
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
                                                         attention_ref,
                                                         bf16_dkv_bound,
                                                         bf16_dq_bound)
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
                f32 = [t.float() for t in (q, k, v, o, do)]
                want = attention_bwd_ref(*f32, lse, causal=causal,
                                         window=window)
                kw = dict(causal=causal, window=window)
                bounds = ([torch.full_like(w, GRAD_ATOL) for w in want]
                          if dtype == torch.float32 else
                          [bf16_dq_bound(*f32, lse, **kw),
                           *bf16_dkv_bound(*f32, lse, **kw)])
                torch.cuda.synchronize()
                for key, g, w, bound in zip(("dq", "dk", "dv"), got, want,
                                            bounds):
                    check(bool(torch.isfinite(g).all()),
                          f"{name} non-finite {key}")
                    diff = (g.float() - w).abs()
                    errs[key] = float(diff.max())
                    share = float((diff / bound).max())
                    errs[f"{key}/bound"] = share
                    check(share <= 1, f"backward {name} {dtype} {key}: "
                          f"max_abs_err {errs[key]}, {share:.3f} of its "
                          "bound")
                del got, want, bounds, f32
            print(f"[3] flash {name:5s} {str(dtype):14s} D={case[5]} "
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


def _variant_counts():
    """Launches of the forward, dq and dkv kernels by variant: the
    tensor-core bf16 kernels and the float32 FMA ones."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    return {"fwd_wgmma": fa.WGMMA_LAUNCHES, "fwd_fma": fa.FMA_LAUNCHES,
            "dq_wgmma": fab.DQ_WGMMA_LAUNCHES, "dq_fma": fab.DQ_FMA_LAUNCHES,
            "dkv_wgmma": fab.DKV_WGMMA_LAUNCHES,
            "dkv_fma": fab.DKV_FMA_LAUNCHES}


def _zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.ssd import ssd
    pa.LAUNCHES = fa.LAUNCHES = fab.DQ_LAUNCHES = fab.DKV_LAUNCHES = 0
    fa.WGMMA_LAUNCHES = fa.FMA_LAUNCHES = 0
    fab.DQ_WGMMA_LAUNCHES = fab.DQ_FMA_LAUNCHES = 0
    fab.DKV_WGMMA_LAUNCHES = fab.DKV_FMA_LAUNCHES = 0
    ssd.LAUNCHES = ssd.TC_LAUNCHES = ssd.FMA_LAUNCHES = 0


def _ssd_count():
    from repro_torch.kernels.ssd import ssd
    return ssd.LAUNCHES


def _ssd_paths():
    """SSD calls by path: the bf16 tensor-core kernels, the float32 FMA
    kernel."""
    from repro_torch.kernels.ssd import ssd
    return {"tc": ssd.TC_LAUNCHES, "fma": ssd.FMA_LAUNCHES}


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
        variants = _variant_counts()
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
    want = cfg.n_layers * runs              # bf16 compute: tensor cores
    check(variants == {"fwd_wgmma": want, "fwd_fma": 0, "dq_wgmma": want,
                       "dq_fma": 0, "dkv_wgmma": want, "dkv_fma": 0},
          f"the bf16 Trainer's flash launches by kernel are {variants}, "
          f"not {want} tensor-core and 0 FMA each")
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
        "launches": launches, "launches_by_kernel": variants}))
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
            _zero_counts()
            t.run()
            variants = _variant_counts()
            runs[dev] = ([m["loss"] for m in t.metrics_log],
                         {k: v.detach().cpu() for k, v in
                          adamw.flatten(t.params).items()},
                         sum(m["lr"] for m in t.metrics_log))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want = cfg.n_layers * 3                 # float32: the FMA kernels
    check(variants == {"fwd_wgmma": 0, "fwd_fma": want, "dq_wgmma": 0,
                       "dq_fma": want, "dkv_wgmma": 0, "dkv_fma": want},
          f"the float32 Trainer's flash launches by kernel are {variants}, "
          f"not 0 tensor-core and {want} FMA each")
    (cl, cp, lr_sum), (gl, gp, _) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(cl, gl))
    p_err = max(float((cp[k] - gp[k]).abs().max()) for k in cp)
    p_tol = 2 * lr_sum + 1e-6
    print(f"[6] reduced smollm fp32, 3 Trainer steps: loss max_abs_err="
          f"{loss_err:.3e} atol=1e-4, params max_abs_err={p_err:.3e} "
          f"atol={p_tol:.3e}; card launches by kernel {variants}")
    check(loss_err <= 1e-4, f"losses differ: {cl} vs {gl}")
    check(p_err <= p_tol, f"params differ by {p_err}")


def _causal_pairs(sq, sk, causal):
    """(query, key) pairs that the causal mask leaves visible."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def phase_flash_timing(gen, card):
    """Each flash kernel at the training shape, bf16 (tensor-core forward
    and dkv) and fp32 (FMA): its time, its bound, the plain version's time
    and the library yardsticks (``scaled_dot_product_attention`` forward,
    and its backward alone, autograd of a saved forward: dq, dk and dv in
    one call; never on the port's path)."""
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
        k_ms = {n: time_ms(fn, 20, flush) for n, fn in calls.items()}
        plain_fwd = time_ms(lambda: attention_ref(q, k, v), 5, flush)
        plain_bwd = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, lse),
                            5, flush)
        qg, kg, vg = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                                  enable_gqa=True)

        lib_fwd = time_ms(sdpa, 20, flush)
        saved = sdpa()
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            saved, (qg, kg, vg), do, retain_graph=True), 20, flush)
        lib_fwd_bwd = time_ms(lambda: torch.autograd.grad(
            sdpa(), (qg, kg, vg), do), 20, flush)
        plain = {"flash_attention_fwd": plain_fwd,
                 "flash_attention_dq": plain_bwd,
                 "flash_attention_dkv": plain_bwd}
        res[dtype] = {}
        for n in calls:
            t_ops = flops[n] / PEAK_FLOPS[dtype] * 1e3
            t_bytes = nbytes[n] / HBM_BYTES_PER_S * 1e3
            res[dtype][n] = {
                "ms": k_ms[n][0], "plain_ms": plain[n][0],
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": lib_fwd[0] if n == "flash_attention_fwd"
                else None}
            print(f"[7] {n} {str(dtype):14s} B={b} H={h} K={kh} S={sq} "
                  f"D={d} causal: kernel_ms={spread(k_ms[n])} "
                  f"plain_ms={spread(plain[n])} bound_ms="
                  f"{res[dtype][n]['bound_ms']:.4f} (flops {flops[n]}, "
                  f"bytes {nbytes[n]}; "
                  f"{flops[n] / k_ms[n][0] / 1e9:.1f} TFLOP/s) [{card}]")
        print(f"[7] flash library yardstick {str(dtype):14s}: "
              f"scaled_dot_product_attention fwd_ms={spread(lib_fwd)} "
              f"bwd_ms={spread(lib_bwd)} (dq, dk, dv in one call) "
              f"fwd+bwd_ms={spread(lib_fwd_bwd)}; plain backward (dq, dk, "
              f"dv in one call) ms={spread(plain_bwd)} [{card}]")
        del q, k, v, do, o, lse, delta, qg, kg, vg, saved
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
             for key in ("fa_fwd", "fa_dq", "fa_dkv")}
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


# ---------------------------------------------------------------------- SSD
def ssd_inputs(case, dtype, gen, init=False):
    """Random SSD scan inputs on the card, dt after softplus and A < 0."""
    b, s, h, p, g, n = case[:6]
    dev = gen.device
    x = torch.randn(b, s, h, p, generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, s, h, generator=gen, device=dev))
    a = -torch.exp(torch.randn(h, generator=gen, device=dev) * 0.5)
    bm = (torch.randn(b, s, g, n, generator=gen, device=dev) * 0.3).to(dtype)
    c = (torch.randn(b, s, g, n, generator=gen, device=dev) * 0.3).to(dtype)
    st = (torch.randn(b, h, p, n, generator=gen, device=dev) if init
          else None)
    return x, dt, a, bm, c, st


def phase_ssd_kernels(gen):
    """The SSD kernel vs ``ref.ssd_chunked`` on the same inputs; returns the
    main shape's bf16 error."""
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.kernels.ssd.ssd import ssd_scan
    cases = ([(f"ssd{i}", c, False) for i, c in enumerate(SSD_CASES)]
             + [("init", SSD_CASES[1], True), ("ragged", SSD_RAGGED, False),
                ("raginit", SSD_RAGGED, True), ("main", SSD_MAIN, False)])
    main_err = None
    for name, case, init in cases:
        chunk = case[6]
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, c, st0 = ssd_inputs(case, dtype, gen, init)
            before = _ssd_paths()
            y, st = ssd_scan(x, dt, a, bm, c, chunk=chunk, init_state=st0)
            tc = dtype == torch.bfloat16
            check(_ssd_paths() == {"tc": before["tc"] + tc,
                                   "fma": before["fma"] + (not tc)},
                  f"ssd {name} {dtype} took the wrong path")
            wy, wst = ssd_chunked(x.float(), dt, a, bm.float(), c.float(),
                                  chunk=chunk, init_state=st0)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                  f"ssd {name} non-finite")
            dy, ds = (y.float() - wy).abs(), (st - wst).abs()
            ey, es = float(dy.max()), float(ds.max())
            excess = max(
                float((dy - SSD_ATOL - SSD_RTOL[dtype] * wy.abs()).max()),
                float((ds - SSD_ATOL - SSD_RTOL[torch.float32]
                       * wst.abs()).max()))
            print(f"[3] ssd {name:7s} {str(dtype):14s} B={case[0]} "
                  f"S={case[1]} H={case[2]} P={case[3]} G={case[4]} "
                  f"N={case[5]} L={chunk}: y max_abs_err={ey:.3e} state "
                  f"max_abs_err={es:.3e} (atol {SSD_ATOL} + rtol "
                  f"{SSD_RTOL[dtype]:g} on y, "
                  f"{SSD_RTOL[torch.float32]:g} on the state; max |y| "
                  f"{float(wy.abs().max()):.2f}, max |state| "
                  f"{float(wst.abs().max()):.2f})")
            check(excess <= 0,
                  f"ssd kernel vs plain {name} {dtype}: y {ey}, state {es}")
            if name == "main" and dtype == torch.bfloat16:
                main_err = max(ey, es)
            del x, dt, bm, c, y, st, wy, wst, dy, ds
    return main_err


def mamba_requests(cfg):
    """MAMBA_PROMPTS batches of token ids in [3, vocab_size), seeded."""
    rs = np.random.RandomState(0)
    return [torch.as_tensor(rs.randint(3, cfg.vocab_size, size=(n, s)))
            for n, s in MAMBA_PROMPTS]


def phase_mamba_serving(card):
    """The mamba serving main path.  Returns its SSD launches, config and
    bf16 weights (for the profile)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = get_config("mamba2-1.3b")
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), dtype=torch.bfloat16, device="cuda")
    n_params = sum(v.numel() for v in _leaves(params))
    # warm-up: cuBLAS handles, the kernel library, the allocator
    warm = torch.randint(3, cfg.vocab_size, (2, 300), device="cuda")
    _, wc = T.prefill(params, cfg, warm, 300)
    T.decode_step(params, cfg, wc, warm[:, -1:], None)
    del wc
    batches = [t.cuda() for t in mamba_requests(cfg)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    per_batch, outs, prefill_launches, decode_launches = [], [], [], 0
    for toks in batches:
        b, s = toks.shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(params, cfg, toks, s + MAMBA_DECODE_STEPS)
        nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        prefill_launches.append(_ssd_count())
        check(_ssd_paths() == {"tc": cfg.n_layers, "fma": 0},
              f"the bf16 prefill's SSD calls by path are {_ssd_paths()}, "
              f"not {cfg.n_layers} tensor-core and 0 FMA")
        _zero_counts()
        gen_toks, step_ms = [nxt], []
        for i in range(MAMBA_DECODE_STEPS):
            t0 = time.perf_counter()
            logits, cache = T.decode_step(params, cfg, cache, nxt,
                                          torch.full((b,), s + i,
                                                     device="cuda"))
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            gen_toks.append(nxt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        decode_launches += _ssd_count()
        _zero_counts()
        out = torch.cat(gen_toks, 1).cpu()
        outs.append(out)
        st = np.asarray(step_ms)
        per_batch.append({
            "requests": b, "prompt_tokens": s, "prefill_s": pre_s,
            "prefill_tokens_per_s": b * s / pre_s,
            "decode_steps": len(step_ms),
            "decode_step_ms_p50": float(np.percentile(st, 50)),
            "decode_step_ms_p90": float(np.percentile(st, 90)),
            "decode_tokens_per_s": b / float(np.percentile(st, 50)) * 1e3})
        del cache, logits
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
    from repro_torch.kernels.paged_attention import paged_attention as pa
    check(pa.LAUNCHES == fa.LAUNCHES == fab.DQ_LAUNCHES
          == fab.DKV_LAUNCHES == 0,
          "the mamba path launched paged or flash attention")
    for out in outs:
        check(out.shape[1] == MAMBA_DECODE_STEPS + 1, "decode length")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              "a token outside the vocabulary")
    check(prefill_launches == [cfg.n_layers] * len(batches),
          f"SSD launches per prefill call {prefill_launches} != "
          f"{cfg.n_layers}")
    check(decode_launches == 0, f"decode launched the SSD kernel "
          f"{decode_launches} times")
    print("[9] " + json.dumps({
        "card": card, "model": "mamba2-1.3b (random weights, bf16)",
        "params": n_params, "requests": sum(n for n, _ in MAMBA_PROMPTS),
        "batches": per_batch, "max_memory_allocated_gb": peak,
        "ssd_launches_per_prefill": prefill_launches,
        "ssd_launches_in_decode": decode_launches,
        "first_tokens": [o[0, :8].tolist() for o in outs]}))
    return sum(prefill_launches), cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_mamba_consistency(cfg, card):
    """Full width, fp32 weights: decode_step after prefill of the 1000-token
    prompts gives the logits of prefill over the 1001 tokens."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(1), dtype=torch.float32, device="cuda")
    toks = mamba_requests(cfg)[1].cuda()
    extra = torch.randint(3, cfg.vocab_size, (toks.shape[0], 1),
                          generator=torch.Generator(device="cuda")
                          .manual_seed(2), device="cuda")
    s = toks.shape[1]
    _, cache = T.prefill(params, cfg, toks, s + 1, cache_dtype=torch.float32)
    got, _ = T.decode_step(params, cfg, cache, extra,
                           torch.full((toks.shape[0],), s, device="cuda"))
    del cache
    want, _ = T.prefill(params, cfg, torch.cat([toks, extra], 1), s + 1,
                        cache_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[9] mamba2-1.3b fp32, decode after prefill of {s} tokens vs "
          f"prefill of {s + 1}: logits max_abs_err={err:.3e} "
          f"atol={MAMBA_CONSISTENCY_ATOL} (max |logit| "
          f"{float(want.abs().max()):.3f}) [{card}]")
    check(bool(torch.isfinite(got).all()), "non-finite decode logits")
    check(err <= MAMBA_CONSISTENCY_ATOL, f"decode vs prefill: {err}")


def phase_mamba_card_vs_cpu():
    """Reduced mamba2, fp32: prefill and 8 teacher-forced decode steps from
    the same weights on the CPU (plain scan) and the card (the kernel)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    cfg = get_config("mamba2-1.3b").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                           dtype=torch.float32, device="cpu")
    toks = torch.as_tensor(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(3, 53)))
    s = 45
    runs = {}
    for dev in ("cpu", "cuda"):
        p = ssm.cast(params, dev, torch.float32)
        logits, cache = T.prefill(p, cfg, toks[:, :s].to(dev), 53,
                                  cache_dtype=torch.float32)
        out = [logits.cpu()]
        for t in range(s, 53):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, t:t + 1].to(dev), None)
            out.append(logits.cpu())
        runs[dev] = (out, {k: v.cpu() for k, v in cache["mamba"].items()})
    (cl, cc), (gl, gc) = runs["cpu"], runs["cuda"]
    v = cfg.vocab_size
    for i, (a, g) in enumerate(zip(cl, gl)):
        check(torch.equal(a[:, :v].argmax(-1), g[:, :v].argmax(-1)),
              f"mamba greedy tokens differ at step {i}")
    lerr = max(float((a - g).abs().max()) for a, g in zip(cl, gl))
    cerr = max(float((cc[k] - gc[k]).abs().max()) for k in cc)
    print(f"[6] reduced mamba2 fp32, prefill + 8 teacher-forced decode "
          f"steps: tokens identical, logits max_abs_err={lerr:.3e}, caches "
          f"max_abs_err={cerr:.3e} atol=1e-4")
    check(lerr <= 1e-4 and cerr <= 1e-4, f"mamba card vs cpu: {lerr} {cerr}")


def ssd_flops_bytes(case, dtype):
    """Visible work of the SSD scan (the lower triangles of C B^T and of
    the scores times x, the off-diagonal C . state and the state update,
    per chunk of real positions) and its least traffic (x, B, C, dt read
    once, y and the final state written once)."""
    b, s, h, p, g, n, chunk = case
    flops = 0
    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)
        flops += 2 * (m * (m + 1) // 2) * (n + p) + 4 * m * p * n
    flops *= b * h
    e = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * h * p * e + 2 * b * s * g * n * e + b * s * h * 4
              + h * 4 + b * h * p * n * 4)
    return flops, nbytes


def phase_ssd_timing(gen, card):
    """The SSD kernel at the main prefill shape, L2 flushed: its time, its
    bound and its plain version's time (no PyTorch call computes the
    scan, so there is no library yardstick)."""
    from repro_torch.kernels.ssd import ssd as ssd_k
    from repro_torch.kernels.ssd.ref import ssd_chunked
    chunk = SSD_MAIN[6]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        x, dt, a, bm, c, _ = ssd_inputs(SSD_MAIN, dtype, gen)
        before = ssd_k.LAUNCHES
        k_ms = time_ms(lambda: ssd_k.ssd_scan(x, dt, a, bm, c, chunk=chunk),
                       10, flush)
        ssd_k.LAUNCHES = before        # timing launches are not main-path
        p_ms = time_ms(lambda: ssd_chunked(x, dt, a, bm, c, chunk=chunk), 3,
                       flush)
        flops, nbytes = ssd_flops_bytes(SSD_MAIN, dtype)
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        res[dtype] = {"ms": k_ms[0], "plain_ms": p_ms[0],
                      "bound_ms": max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "library_ms": None}
        print(f"[7] ssd {str(dtype):14s} B={SSD_MAIN[0]} S={SSD_MAIN[1]} "
              f"H={SSD_MAIN[2]} P={SSD_MAIN[3]} G={SSD_MAIN[4]} "
              f"N={SSD_MAIN[5]} L={chunk}: kernel_ms={spread(k_ms)} "
              f"plain_ms={spread(p_ms)} bound_ms="
              f"{res[dtype]['bound_ms']:.4f} (flops {flops}, bytes "
              f"{nbytes}; {flops / k_ms[0] / 1e9:.2f} "
              f"TFLOP/s) [{card}]")
        del x, dt, a, bm, c
    return res


def phase_mamba_profile(cfg, params, card):
    """One full-batch prefill call (8 x 2048) and MAMBA_PROFILE_STEPS
    steady decode steps after it, each timed untraced and then traced."""
    from repro_torch.models import transformer as T
    toks = mamba_requests(cfg)[0].cuda()
    b, s = toks.shape
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def prefill():
        return T.prefill(params, cfg, toks, s + 64)

    def decode(cache, n):
        nxt = toks[:, -1:]
        for i in range(n):
            logits, cache = T.decode_step(params, cfg, cache, nxt, None)
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
        return cache

    for what, steps in (("prefill", 1), ("decode", MAMBA_PROFILE_STEPS)):
        _, cache = prefill()
        cache = decode(cache, 2)                    # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "prefill":
            _, cache = prefill()
        else:
            cache = decode(cache, steps)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) * 1e3 / steps
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                _, cache = prefill()
            else:
                cache = decode(cache, steps)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3 / steps
        del cache
        kernels, busy, by_name = _profile_summary(prof, steps)
        total = sum(t for t, _ in by_name.values())
        ssd_ms = sum(t for n, (t, _) in by_name.items()
                     if re.search(r"ssd_\w*kernel", n))
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        print(f"[8] mamba {what} " + json.dumps({
            "card": card, "model": "mamba2-1.3b (random weights, bf16)",
            "batch": b, "prompt_tokens": s, "calls": steps,
            "wall_ms_untraced": untraced, "wall_ms_traced": traced,
            "device_busy_ms": busy,
            "device_idle_share_untraced": 1 - busy / untraced,
            "device_idle_share_traced": 1 - busy / traced,
            "kernels_per_call": len(kernels) / steps,
            "ssd_ms_per_call": ssd_ms / steps,
            "ssd_share_of_kernel_time": ssd_ms / total,
            "top_kernels_ms_per_call": [
                {"name": n[:80], "ms": t / steps, "calls": c / steps}
                for n, (t, c) in top]}))


def _kernel_name(mangled: str) -> str:
    """``name<type,ints>`` (or ``name<ints>`` for the bf16-only tensor-core
    kernels) from a mangled kernel name."""
    k = re.search(r"\d+([a-z]+(?:_[a-z]+)*_kernel)"
                  r"(?:I(f|13__nv_bfloat16)?((?:Li\d+E)+))?", mangled)
    if not k:
        return mangled
    if k.group(3) is None:
        return k.group(1)
    ints = ",".join(re.findall(r"\d+", k.group(3)))
    dtype = {"f": "float,", "13__nv_bfloat16": "bf16,"}.get(k.group(2), "")
    return f"{k.group(1)}<{dtype}{ints}>"


def build_report(build):
    """Print each kernel's registers, spills and shared memory, and every
    ptxas warning (such as wgmma serialised for want of registers), from
    nvcc's ptxas report."""
    for src in sorted(build.sources()):
        name, spill = None, ""
        for line in build.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            w = re.search(r"(\(C\d{4}\)[^']*)'(\S+)'", line)
            if m:
                name = _kernel_name(m.group(1))
            elif w:
                print(f"[2] ptxas warning {src}: {_kernel_name(w.group(2))}:"
                      f" {w.group(1).strip()}")
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
    ssd_err = phase_ssd_kernels(gen)
    pa_launches, cfg, params = phase_main_path(card)
    check(all(n == 0 for n in _flash_counts().values()),
          "the serving path launched a flash-attention kernel")
    check(_ssd_count() == 0, "the serving path launched the SSD kernel")
    phase_h2o_serving(card)
    _zero_counts()
    phase_shell(card, cfg, params)
    fa_launches, trainer, step_fn = phase_train(card)
    check(_ssd_count() == 0, "the training path launched the SSD kernel")
    ssd_launches, mcfg, mparams = phase_mamba_serving(card)
    phase_mamba_consistency(mcfg, card)
    phase_card_vs_cpu()
    phase_train_card_vs_cpu()
    phase_mamba_card_vs_cpu()
    timing = phase_timing(pa, paged_attention_ref, gen, card)
    fa_timing = phase_flash_timing(gen, card)
    ssd_timing = phase_ssd_timing(gen, card)
    phase_decode_profile(cfg, params, card)
    del params
    phase_train_profile(trainer, step_fn, card)
    del trainer, step_fn
    phase_mamba_profile(mcfg, mparams, card)

    k_ms, p_ms, bound = timing[("main", torch.bfloat16)]
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
    kernels.append({
        "name": "ssd", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES, "launches": ssd_launches,
        "max_abs_err": ssd_err, **ssd_timing[torch.bfloat16]})
    for k in kernels:
        k["variants"] = VARIANTS[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
