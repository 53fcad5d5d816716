"""Scenario: an always-on serving front door with SLOs.

The port of ``examples/gateway_serving.py`` (decode on the CUDA card).
Requests do not arrive in tidy batches: they show up on their own clock
(Poisson), in tiers (gold with tight deadlines, best-effort without),
and sometimes with deadlines that cannot possibly be met.  The
ServingGateway bridges that open-arrival world to the slot-granular
engine: continuous batching (finished rows backfilled every step),
chunked prefill (a long prompt streams in 32-token chunks instead of
stalling everyone), SLO admission (infeasible deadlines rejected typed,
queued deadlines expired, priorities aged as slack shrinks), and live
per-request token streams with TTFT/TPOT measured from arrival.

    PYTHONPATH=src python examples_torch/gateway_serving.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.faults import FaultKind
from repro_torch.core.port import PortError
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.gateway import ServingGateway


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12,
                    help="Poisson arrivals in the mixed-tier run")
    ap.add_argument("--long-prompt", type=int, default=192,
                    help="tokens of the long prompt beside the shorts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=device)
    rng = np.random.RandomState(42)

    def new_engine():
        mmu = MMU(MMUConfig(page_size=16, n_pages=256))
        return ServingEngine(cfg, params, mmu, max_batch=4, max_len=256,
                             seed=7, prefill_chunk=32, device=device)

    def prompt(n):
        return rng.randint(0, cfg.vocab_size, size=n).tolist()

    # --- 1. Poisson traffic in two SLO tiers, served continuously --------
    gw = ServingGateway(new_engine(), mode="continuous", admission="slo",
                        min_obs=1, aging_window_s=30.0)
    # warm the engine's timing model through the gateway
    for _ in range(4):
        gw.submit(prompt(17), max_new_tokens=8)
    gw.drain()
    est = gw._service_estimate(17, 8)
    print(f"timing model warm: single-request estimate ~{est * 1e3:.1f} ms")

    t0 = time.perf_counter()
    arrivals, streams = 0.0, []
    for k in range(args.requests):
        arrivals += float(rng.exponential(0.01))
        tier = "gold" if k % 3 else "best-effort"
        while time.perf_counter() - t0 < arrivals:
            gw.step()
        streams.append((tier, gw.submit(
            prompt(17), max_new_tokens=8,
            priority=1 if tier == "gold" else 0,
            deadline_s=20.0 if tier == "gold" else None)))
    gw.drain()
    st = gw.stats()
    done = sum(1 for _, s in streams if s.done)
    print(f"served {done}/{args.requests} mixed-tier requests: "
          f"goodput {st['goodput']:.1f}/s, TTFT p99 "
          f"{st['ttft_p99_ms']:.1f} ms, TPOT p50 {st['tpot_p50_ms']:.2f} ms")
    assert all(s.done for _, s in streams)
    # gold requests carry deadlines inside the aging window, so their
    # effective priority was boosted while queued
    aged = max(s.eff_priority - s.priority for t, s in streams
               if t == "gold")
    print(f"deadline-driven aging boosted a gold request by +{aged}")
    assert aged >= 1

    # --- 2. live rejection: a deadline the engine cannot meet ------------
    try:
        gw.submit(prompt(64), max_new_tokens=64, deadline_s=0.2 * est)
        raise SystemExit("infeasible deadline was not rejected")
    except PortError as e:
        assert e.kind == FaultKind.SLO_INFEASIBLE and not e.retryable
        print(f"infeasible deadline rejected at the door: {e.kind}")

    # --- 3. expiry: a feasible deadline that dies in the queue -----------
    gw2 = ServingGateway(new_engine())      # cold model: door check off
    doomed = gw2.submit(prompt(17), max_new_tokens=8, deadline_s=0.01)
    time.sleep(0.02)
    gw2.step()
    assert doomed.rejected and doomed.error.kind == FaultKind.SLO_EXPIRED
    assert doomed.rid is None               # never wasted a prefill
    print("queued request expired typed before burning page credits")

    # --- 4. chunked prefill keeps shorts fast next to a long prompt ------
    gw3 = ServingGateway(new_engine(), admission="fifo")
    long_s = gw3.submit(prompt(args.long_prompt), max_new_tokens=8)
    shorts = [gw3.submit(prompt(15), max_new_tokens=8) for _ in range(3)]
    gw3.drain()
    ttfts = [s.ttft() * 1e3 for s in shorts]
    print(f"shorts' TTFT next to a {args.long_prompt}-token prompt (chunked "
          f"prefill): {max(ttfts):.1f} ms worst-case")
    assert long_s.done and all(s.done for s in shorts)
    print("gateway demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
