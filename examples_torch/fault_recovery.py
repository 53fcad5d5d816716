"""Self-healing shell: watchdog detects a wedged slot, recovers it
KV-intact, and decoding resumes token-for-token.

The port of ``examples/fault_recovery.py``, on the PyTorch shell (its
device the CUDA card).  One shell serves tenant "gold" (paged LM decode,
greedy AND sampled rows).  Mid-decode we arm a seeded fault plan — an IO
error fails a billed decode-IO future with a typed PortError, and a
page-fault storm churns KV pages through the evict-with-copy pager —
then the slot goes silent while it still has pending work.
``Shell.check_health`` flags it WEDGED (stale heartbeat + pending work)
and recovers it in place: quiesce, snapshot through the migration
container, cold-reset the device soft state, restore the KV pages,
replay held invocations.  A fault-free oracle proves continuity:
token-for-token identical output.

Run: PYTHONPATH=src python examples_torch/fault_recovery.py [--device cpu]
Exits non-zero on any lost, duplicated, or diverged completion.
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core import (FaultKind, FaultPlan, FaultSpec, Invocation,
                              Shell, ShellConfig)
from repro_torch.core.port import PortError
from repro_torch.core.services import MMUConfig
from repro_torch.core.services.mmu import MMU
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine

PAGE, POOL = 16, 128


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-new", type=int, default=24,
                    help="tokens each request decodes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=device)
    shell = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=POOL,
                                   host_pool_pages=POOL)},
        n_vfpgas=2), device=device)
    shell.build()
    eng = ServingEngine(cfg, params, shell.services.get("mmu"),
                        max_batch=3, max_len=128, shell=shell, slot=0,
                        tenant="gold", device=device)
    oracle = ServingEngine(cfg, params, MMU(MMUConfig(page_size=PAGE,
                                                      n_pages=POOL)),
                           max_batch=3, max_len=128, device=device)
    reqs = [(list(range(3, 27)), 0.0), (list(range(3, 40)), 0.0),
            (list(range(3, 20)), 1.3)]
    for prompt, temp in reqs:
        eng.submit(prompt, max_new_tokens=args.max_new, temperature=temp)
        oracle.submit(prompt, max_new_tokens=args.max_new, temperature=temp)
    for _ in range(4):
        eng.step()
        oracle.step()
    print(f"[fault] mid-decode: {eng.active} live rows, "
          f"{shell.services.get('mmu').utilization()['pages_used']} KV "
          "pages")

    # -- a seeded storm: typed IO failure + page-fault churn ----------------
    plan = FaultPlan([FaultSpec(FaultKind.IO_ERROR, tenant="gold"),
                      FaultSpec(FaultKind.PAGE_FAULT_STORM, count=4)],
                     seed=7)
    shell.set_fault_plan(plan)
    try:
        eng.port.submit(Invocation.io(64, tenant="gold")).result(
            timeout=10.0)
        raise SystemExit("armed IO fault did not fire")
    except PortError as e:
        print(f"[fault] typed failure propagated: kind={e.kind} "
              f"slot={e.slot} tenant={e.tenant} retryable={e.retryable}")
    for _ in range(PAGE + 2):             # storm churns pages mid-decode:
        eng.step()                        # every row crosses a page
        oracle.step()                     # boundary, so the pager probes
    shell.set_fault_plan(None)
    print(f"[fault] plan fired {plan.stats()['fired_total']} fault(s); "
          f"mmu page_faults={shell.services.get('mmu').page_faults}")

    # -- the slot goes quiet with work pending: watchdog flags + heals ------
    shell.health.heartbeat_timeout_s = 0.05
    time.sleep(0.12)                      # heartbeat goes stale
    res = shell.check_health(auto_recover=True)
    if res["wedged"] != [0] or res["recovered"] != [0]:
        raise SystemExit(f"watchdog did not recover the slot: {res}")
    ev = [e for e in shell.health.status()["events"]
          if e["event"] == "recovery"][-1]
    print(f"[heal] slot 0 recovered in {ev['downtime_s'] * 1e3:.1f} ms "
          "(quiesce -> CYBS snapshot -> cold reset -> KV restore)")

    while eng.pending():
        eng.step()
    while oracle.pending():
        oracle.step()
    got = {r.rid: r.out_tokens for r in eng.completed}
    want = {r.rid: r.out_tokens for r in oracle.completed}
    if got != want:
        raise SystemExit("DIVERGED: recovered tenant != fault-free oracle")
    st = shell.attach(0).stats()
    if st["submitted"] != st["completed"] + st["failed"]:
        raise SystemExit(f"lost/dup completions: {st}")
    h = shell.status()["health"]
    print(f"[ok] token-for-token parity across recovery "
          f"({sum(len(t) for t in got.values())} tokens, "
          f"{len(got)} requests); faults_total={h['faults_total']} "
          f"recoveries={h['recoveries']}")
    shell.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
