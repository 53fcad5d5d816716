"""Time one source tree's SSD backward at the training shapes.

    python3 scripts/ssd_bwd_ab.py [--src DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout's
``src``), so that two trees can be compared on one card: unpack the other
tree (``git archive``) into a git-ignored directory and run the script
for each in turns (old, new, new, old).  It uses only the wrapper's
public call ``ssd_scan_bwd(x, dt, A, Bm, C, dy, chunk=...)``, bf16, on
the inputs ``chip_smoke.py`` phase 7 times: mamba2-1.3b's training shape
(B 4, S 2048, H 64, P 64, N 128, L 256) and zamba2-2.7b's (H 80, N 64).
Per shape it prints the CUDA-event ms (median, p10, p90; L2 flushed
before each call), the kernels' device ms per call from
``torch.profiler`` with the launches of each kernel, the bound of
``chip_smoke.ssd_bwd_flops_bytes`` and the TFLOP/s, as one JSON line with
the card's name and power limit.  Needs the CUDA card; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=ROOT,
                    help="the tree whose repro_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))
    sys.path.insert(1, ROOT)            # chip_smoke's inputs and timers
    sys.path.insert(2, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from paged_attention_ab import device_ms
    from repro_torch.kernels.ssd import ssd as ssd_k

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {"card": cs.card_line(), "src": os.path.abspath(args.src)}
    for name, case in (("mamba2", cs.SSD_TRAIN_MAMBA2),
                       ("zamba2", cs.SSD_TRAIN_ZAMBA2)):
        x, dt, a, bm, c, _ = cs.ssd_inputs(case, torch.bfloat16, gen)
        dy = torch.randn(x.shape, generator=gen, device="cuda").to(
            torch.bfloat16)

        def call():
            return ssd_k.ssd_scan_bwd(x, dt, a, bm, c, dy, chunk=case[6])

        for _ in range(3):              # build, warm, clocks up
            call()
        ev = cs.time_ms(call, 10, flush)
        dev, kernels = device_ms(call, 5, flush)
        flops, nbytes = cs.ssd_bwd_flops_bytes(case, torch.bfloat16)
        bound = max(flops / cs.PEAK_FLOPS[torch.bfloat16],
                    nbytes / cs.HBM_BYTES_PER_S) * 1e3
        res[name] = {"event_ms": ev, "device_ms": dev, "kernels": kernels,
                     "bound_ms": bound, "tflops": flops / ev[0] / 1e9}
        del x, dt, a, bm, c, dy
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
