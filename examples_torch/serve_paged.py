"""Scenario: LLM serving with batched requests on the paged-KV MMU.

The port of ``examples/serve_paged.py``: the paper's LLM-decode
observation (Fig 1) end-to-end: requests from multiple cThreads share one
decode pipeline; the MMU pages the KV cache (variable page size), pages
fault/evict under pressure, and continuous batching keeps the pipeline
full.  Each decode step runs the paged-attention CUDA kernel on the card.

    PYTHONPATH=src python examples_torch/serve_paged.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=device)

    # deliberately tight page pool: exercises fault/evict under pressure
    mmu = MMU(MMUConfig(page_size=16, n_pages=96, tlb_entries=32,
                        tlb_assoc=4))
    engine = ServingEngine(cfg, params, mmu, max_batch=4, max_len=128,
                           device=device)

    rng = np.random.RandomState(0)
    for i in range(args.requests):
        plen = int(rng.randint(5, 40))
        engine.submit(rng.randint(3, cfg.vocab_size, plen).tolist(),
                      max_new_tokens=int(rng.randint(4, 16)),
                      temperature=0.0 if i % 2 else 0.8, tid=i)

    stats = engine.run()
    print("engine:", {k: (round(v, 2) if isinstance(v, float) else v)
                      for k, v in stats.items()})
    print("mmu:", mmu.utilization())
    for r in engine.completed[:3]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    assert stats["completed"] == args.requests
    assert mmu.utilization()["pages_used"] == 0, "all pages must be freed"
    print("OK: all requests served, pages reclaimed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
