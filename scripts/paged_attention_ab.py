"""Time one source tree's paged-attention kernel at the decode shapes.

    python3 scripts/paged_attention_ab.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's
``src``), so that two trees can be compared on one card: unpack the other
tree (``git archive``) into a git-ignored directory and run the script
for each in turns (old, new, new, old).  It uses only the wrapper's
public call ``paged_attention(q, k_pages, v_pages, block_tables,
seq_lens)``, on the inputs ``chip_smoke.py`` phase 7 times: smollm-135m's
decode (B 16, H 9, K 3, D 64, page 16, maxp 64) and h2o-danube-3-4b's
(B 8, H 32, K 8, D 120, page 16, maxp 66), bf16.  Per shape it prints the
CUDA-event ms (median, p10, p90; L2 flushed before each call), the
kernels' device ms per call from ``torch.profiler`` (every kernel of the
call, the flush's excluded) and the wrapper's host µs per call (100 calls,
no synchronise), as one JSON line with the card's name and power limit.
Needs the CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms(fn, reps, flush):
    """Median device ms per call of every kernel ``fn`` launches."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    spans = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "FillFunctor" not in e.name]
    per_name = {}
    for e in spans:
        per_name.setdefault(e.name, []).append(
            (e.time_range.end - e.time_range.start) / 1e3)
    # every kernel of the call runs once per call
    return sum(float(np.median(v)) for v in per_name.values()), {
        kernel_id(n): len(v) for n, v in per_name.items()}


def kernel_id(name: str) -> str:
    """The ``..._kernel`` identifier in a demangled kernel name."""
    m = re.search(r"(\w+_kernel)", name)
    return m.group(1) if m else name[:60]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT,
                    help="the tree whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("paged_attention_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    sys.path.insert(1, ROOT)            # chip_smoke's inputs and timers
    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {"card": cs.card_line(), "src": os.path.abspath(args.src)}
    for name, shape, lens in (
            ("main", cs.MAIN_SHAPE, cs.main_lens(16, 16, 64)),
            ("h2o", cs.H2O_SHAPE, cs.h2o_lens())):
        q, kp, vp, tab, ln = cs.pa_inputs(shape, lens, torch.bfloat16, gen)

        def call():
            return pa.paged_attention(q, kp, vp, tab, ln)

        for _ in range(200):            # build, warm, clocks up
            call()
        ev = cs.time_ms(call, 50, flush)
        dev, kernels = device_ms(call, 30, flush)
        res[name] = {"event_ms": ev, "device_ms": dev, "kernels": kernels,
                     "host_us": cs.host_us(call)}
        del q, kp, vp, tab, ln
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
