"""Serving launcher: paged continuous-batching engine over the MMU service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --max-new 16 --batch 8 [--device cpu]

Twin of ``repro.launch.serve`` with the same flags; it serves on the CUDA
card unless ``--device`` names another.  As in the reference,
``--reduced`` is a ``store_true`` flag whose default is already True, so
the launcher always serves the reduced config.  Weights are float32 and
random, drawn on the CPU from ``--seed`` (the same for every device);
prompts are drawn with numpy from ``--seed``, as the reference draws
them.  Prints the engine's stats as JSON.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--n-pages", type=int, default=512)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = T.init_params(
        cfg, generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.float32, device=device)
    mmu = MMU(MMUConfig(page_size=args.page_size, n_pages=args.n_pages))
    eng = ServingEngine(cfg, params, mmu, max_batch=args.batch,
                        max_len=args.max_len, seed=args.seed, device=device)

    rng = np.random.RandomState(args.seed)
    for _ in range(args.requests):
        plen = int(rng.randint(4, 48))
        eng.submit(rng.randint(3, cfg.vocab_size, size=plen).tolist(),
                   max_new_tokens=args.max_new,
                   temperature=args.temperature)
    stats = eng.run()
    lat = [r.t_first_token - r.t_submit for r in eng.completed]
    stats["ttft_p50_s"] = float(np.percentile(lat, 50)) if lat else 0.0
    stats["mmu"] = eng.mmu.utilization()
    print(json.dumps(stats, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
