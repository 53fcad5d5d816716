"""Drain-aware hot-swap through the unified Port API (Port API v2).

The port of ``examples/hotswap_port.py``, on the PyTorch shell (its
device the CUDA card).  Two tenants drive two slots through
``port.submit`` while slot 0 is hot-swapped from AES-ECB to HyperLogLog
mid-traffic.  The demo prints the swap timings, the hold-and-replay
counts, and verifies the two invariants the API guarantees:

  * zero lost / duplicated completions across the swap boundary;
  * the OTHER tenant's traffic never pauses and never stalls.

Run: PYTHONPATH=src python examples_torch/hotswap_port.py [--device cpu]
"""
import argparse
import threading
import time

import numpy as np

from repro_torch.apps import make_aes_artifact, make_hll_artifact
from repro_torch.core import Invocation, Oper, SgEntry, Shell, ShellConfig
from repro_torch.core.services import AESConfig, MMUConfig
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--invocations", type=int, default=150,
                    help="invocations each tenant submits")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    shell = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=64, n_pages=256),
                  "encryption": AESConfig()},
        n_vfpgas=2), device=device)
    shell.build()
    shell.register_tenant("gold", 2.0, slots=(0,))
    shell.register_tenant("bronze", 1.0, slots=(1,))
    shell.load_app(0, make_aes_artifact("ecb"))
    shell.load_app(1, make_aes_artifact("cbc"))

    gold, bronze = shell.attach(0), shell.attach(1)
    caps = gold.capabilities()
    print(f"slot0 capabilities: name={caps.name} streams={caps.streams} "
          f"csr_map={dict(caps.csr_map)} mem_model={caps.mem_model}")

    n = args.invocations
    futs = {"gold": [], "bronze": []}

    def drive(port, key):
        for i in range(n):
            buf = (np.arange(256, dtype=np.uint32) + i).view(np.uint8)
            futs[key].append(port.submit(Invocation.from_sg(SgEntry(
                src=buf, length=buf.size, opcode=Oper.KERNEL))))

    threads = [threading.Thread(target=drive, args=(gold, "gold")),
               threading.Thread(target=drive, args=(bronze, "bronze"))]
    for t in threads:
        t.start()
    time.sleep(0.005)                      # let traffic get in flight

    # ---- the hot-swap: AES-ECB -> HLL, mid-traffic ----------------------
    stats = shell.reconfigure(0, make_hll_artifact())
    for t in threads:
        t.join()

    comps_g = [f.result(timeout=30.0) for f in futs["gold"]]
    comps_b = [f.result(timeout=30.0) for f in futs["bronze"]]
    assert len(comps_g) == n and all(c.ok for c in comps_g)
    assert len(comps_b) == n and all(c.ok for c in comps_b)
    ps = gold.stats()
    assert ps["submitted"] == ps["completed"] == n
    bs = shell.scheduler.stats()["tenants"]["bronze"]
    assert bs["completions"] == n and bs["intake_stalls"] == 0

    print("\nhot-swap aes_ecb -> hll on busy slot 0:")
    print(f"  drain_s={stats['drain_s']*1e3:.2f} ms  "
          f"load kernel_s={stats['kernel_s']*1e3:.2f} ms  "
          f"total_s={stats['total_s']*1e3:.2f} ms")
    print(f"  invocations held+replayed on new logic: "
          f"{int(stats['replayed'])}/{n}")
    print(f"  gold: {ps['submitted']} submitted -> "
          f"{ps['completed']} completed (zero lost/dup)")
    print(f"  bronze (untouched tenant): {bs['completions']}/{n} done, "
          f"{bs['intake_stalls']} stalls, "
          f"mean latency {bs['mean_latency_s']*1e3:.2f} ms")
    # the HLL results only exist for replayed invocations — the swap
    # boundary is visible in the completion payloads, not in their count
    hll_like = sum(1 for c in comps_g if np.isscalar(c.result)
                   or getattr(c.result, "ndim", 1) == 0)
    print(f"  completions executed by new logic (HLL estimates): "
          f"{hll_like}")
    shell.drain()
    shell.close()
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
