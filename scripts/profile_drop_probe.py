"""How many device events a ``torch.profiler`` trace drops as the process ages.

    python3 scripts/profile_drop_probe.py [--minutes 8] [--every 50]

Builds the port's kernels, then every ``--every`` seconds for ``--minutes``
traces 30 paged-attention calls at ``chip_smoke.py``'s main decode shape
(B 16, H 9, K 3, D 64, page 16, maxp 64; float32), each after an L2 flush,
in three ways:

- ``bare``: the calls alone; prints how many of the 60 device events
  (30 flushes, 30 paged kernels) the trace lost;
- ``spin``: a 50 ms spin kernel ahead of the calls; prints the paged
  kernels the trace holds, and whether it holds the spin;
- ``pad``: ``chip_smoke.pa_device_ms``, which leads each trace with
  ``PROFILE_PAD_KERNELS`` empty kernels and takes up to three traces;
  prints the paged kernels held and the number of the trace used.

One JSON line a round, with the process's age and the card's name and
power limit.  Needs the CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 30


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--minutes", type=float, default=8.0)
    ap.add_argument("--every", type=float, default=50.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_drop_probe: needs the CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import paged_attention as pa

    _build.build()
    card = cs.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    q, kp, vp, tab, ln = cs.pa_inputs(cs.MAIN_SHAPE, cs.main_lens(16, 16, 64),
                                      torch.float32, gen)

    def call():
        return pa.paged_attention(q, kp, vp, tab, ln)

    for _ in range(200):
        call()
    cuda = torch.autograd.DeviceType.CUDA

    def trace(lead_cycles):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            if lead_cycles:
                torch.cuda._sleep(lead_cycles)
            for _ in range(REPS):
                flush.zero_()
                call()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == cuda]
        n_pa = sum("pa_decode_kernel" in e.name for e in ev)
        n_spin = sum("spin_kernel" in e.name for e in ev)
        return len(ev) - n_spin, n_pa, n_spin

    while True:
        n_ev, _, _ = trace(0)
        _, n_spin_pa, n_spin = trace(200 * cs.SPIN_CYCLES)
        _, _, n_pad, used = cs.pa_device_ms(call, REPS, flush)
        age = time.perf_counter() - t_start
        print(json.dumps({
            "age_s": round(age, 1), "bare_lost_of_60": 2 * REPS - n_ev,
            "spin_pa_held": n_spin_pa,
            "spin_held": n_spin == 1,
            "pad_pa_held": n_pad, "pad_trace_used": used, "card": card}),
            flush=True)
        if age > args.minutes * 60:
            return 0
        time.sleep(args.every)


if __name__ == "__main__":
    sys.exit(main())
