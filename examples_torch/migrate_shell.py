"""Quiesce-and-migrate: move a LIVE LM-serving tenant between shells.

The port of ``examples/migrate_shell.py``, on PyTorch shells (their
device the CUDA card).  Two shells serve the same reduced model.  Tenant
"gold" decodes on shell A; mid-decode we call ``migrate(A, B, "gold")``
— the slot quiesces, the tenant's page tables AND actual KV pages are
gathered into a versioned snapshot container, restored onto shell B's
MMU (fresh pages, rebuilt device block table), and decode continues on
B.  An unmigrated oracle engine proves continuity: token-for-token
identical output.  A bronze tenant driving shell B's slot 1 throughout
shows non-interference.

Run: PYTHONPATH=src python examples_torch/migrate_shell.py [--device cpu]
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.apps import make_passthrough_artifact
from repro_torch.configs import get_config
from repro_torch.core import (Invocation, Oper, SgEntry, Shell, ShellConfig,
                              migrate)
from repro_torch.core.services import MMUConfig
from repro_torch.core.services.mmu import MMU
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine

PAGE, POOL = 16, 128


def mk_shell(device) -> Shell:
    s = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=POOL)},
        n_vfpgas=2), device=device)
    s.build()
    return s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens each request decodes")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=device)
    shell_a, shell_b = mk_shell(device), mk_shell(device)
    eng_a = ServingEngine(cfg, params, shell_a.services.get("mmu"),
                          max_batch=3, max_len=128, shell=shell_a, slot=0,
                          tenant="gold", device=device)
    eng_b = ServingEngine(cfg, params, shell_b.services.get("mmu"),
                          max_batch=3, max_len=128, shell=shell_b, slot=0,
                          tenant="gold", device=device)
    oracle = ServingEngine(cfg, params, MMU(MMUConfig(page_size=PAGE,
                                                      n_pages=POOL)),
                           max_batch=3, max_len=128, device=device)

    # bronze tenant hammers shell B's OTHER slot for the whole demo
    shell_b.register_tenant("bronze", 1.0, slots=(1,))
    shell_b.load_app(1, make_passthrough_artifact())
    bronze_port = shell_b.attach(1)
    bronze_stop = threading.Event()
    bronze_lat = []

    def bronze_driver():
        while not bronze_stop.is_set():
            t0 = time.perf_counter()
            comp = bronze_port.submit(Invocation.from_sg(SgEntry(
                src=np.zeros(512, np.uint8), length=512,
                opcode=Oper.LOCAL_TRANSFER))).result(timeout=30.0)
            assert comp.ok
            bronze_lat.append(time.perf_counter() - t0)
    bronze = threading.Thread(target=bronze_driver)
    bronze.start()

    prompts = [(list(range(3, 8)), 0.0), (list(range(3, 20)), 0.0),
               (list(range(3, 12)), 1.3)]
    for p, temp in prompts:
        eng_a.submit(p, max_new_tokens=args.max_new, temperature=temp)
        oracle.submit(p, max_new_tokens=args.max_new, temperature=temp)
    for _ in range(5):                      # decode a few steps on A
        eng_a.step()
        oracle.step()
    mid = {r.rid: len(r.out_tokens) for r in eng_a.slots if r}
    print(f"tenant 'gold' live on shell A: {len(mid)} requests, "
          f"{sum(mid.values())} tokens decoded so far")

    # ---- the migration -------------------------------------------------
    report = migrate(shell_a, shell_b, "gold")
    print(f"\nmigrated A -> B: {report.n_requests} in-flight requests, "
          f"{report.n_pages} KV pages, "
          f"{report.payload_bytes / 1e6:.2f} MB snapshot")
    print(f"  downtime      {report.downtime_s * 1e3:8.2f} ms   "
          f"(quiesce {report.quiesce_s * 1e3:.2f} / "
          f"snapshot {report.snapshot_s * 1e3:.2f} / "
          f"restore {report.restore_s * 1e3:.2f} / "
          f"replay {report.replay_s * 1e3:.2f})")

    # ---- continuity proof ----------------------------------------------
    while eng_b.pending():
        eng_b.step()
    while oracle.pending():
        oracle.step()
    got = {r.rid: r.out_tokens for r in eng_b.completed}
    want = {r.rid: r.out_tokens for r in oracle.completed}
    assert got == want, "migrated decode diverged from the oracle"
    print(f"\ncontinuity: {len(got)} requests completed on shell B, "
          "token-for-token identical to the unmigrated oracle")
    for rid, toks in sorted(got.items()):
        print(f"  rid {rid}: ...{toks[-6:]}")
    assert shell_a.services.get("mmu").utilization()["pages_used"] == 0
    print("shell A pages fully released")

    bronze_stop.set()
    bronze.join()
    lat = np.asarray(bronze_lat) * 1e3
    stats = shell_b.scheduler.stats()["tenants"]["bronze"]
    assert stats["intake_stalls"] == 0
    print(f"bronze bystander on shell B: {len(lat)} requests, "
          f"p99 {np.percentile(lat, 99):.2f} ms, "
          f"{stats['intake_stalls']} stalls (undisturbed)")
    shell_a.drain()
    shell_b.drain()
    shell_a.close()
    shell_b.close()
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
