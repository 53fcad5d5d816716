"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (into the
git-ignored ``build/``), holds each kernel against its plain PyTorch
version on the card, serves requests end to end through
``repro_torch.serve.engine.ServingEngine`` at the full width of
smollm-135m (seeded random weights), checks the card against the CPU on
the reduced model, times the kernels and profiles a decode step.  Phases,
in order:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel, print the build seconds;
  3. kernel vs plain version on the card (fp32 and bf16), with and
     without the split of rows over several blocks;
  4. main path: 24 requests through the engine at full width, bf16;
  5. card vs CPU: decode_step_paged on the reduced model, fp32;
  6. kernel timing at the main path's shape;
  7. profile: where a steady decode step of the main path's engine, every
     slot full, spends its time (host wall per step untraced and traced,
     device busy time per step, the device's idle share, launches per
     step, the kernels that take the most device time).

Any failed phase ends the script with a non-zero exit and no result
line.  The line before the last is a JSON object describing each kernel;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PA_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
PA_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:47"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
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
    pa.LAUNCHES = 0
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
    print(f"[5] reduced smollm fp32, 8 teacher-forced decode steps: tokens "
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
        print(f"[6] paged_attention {str(dtype):14s} B={b} H={h} K={kh} "
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


def phase_profile(cfg, params, card):
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
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), "profile: the trace holds no device kernel")
    busy = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels]) / PROFILE_STEPS
    by_name = {}
    for e in kernels:
        t = (e.time_range.end - e.time_range.start) / 1e3
        n, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (n + t, c + 1)
    total = sum(t for t, _ in by_name.values())
    pa_ms = sum(t for n, (t, _) in by_name.items()
                if "paged_attention" in n or "combine_kernel" in n)
    untraced = float(np.mean(walls))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print("[7] " + json.dumps({
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
    for line in _build.build_log("paged_attention").splitlines():
        if "registers" in line:
            print(f"[2] ptxas: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = phase_kernels(pa, paged_attention_ref, gen)
    launches, cfg, params = phase_main_path(card)
    phase_card_vs_cpu()
    timing = phase_timing(pa, paged_attention_ref, gen, card)
    phase_profile(cfg, params, card)

    k_ms, p_ms, bound = timing[torch.bfloat16]
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda", "source": PA_SOURCE,
        "replaces": PA_REPLACES, "launches": launches,
        "max_abs_err": main_err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
