"""Scenario: one shell, three tenants, live reconfiguration.

The port of ``examples/multitenant_shell.py``, on the PyTorch shell
(its device the CUDA card).  Walks the paper's headline features in one
script:
  1. build a shell with MMU + AES + sniffer services;
  2. load three different apps into three vFPGA slots (AES-ECB tenant,
     HyperLogLog tenant, vector-add tenant);
  3. run cThread traffic through the credit-scheduled link while the
     sniffer captures packets;
  4. hot-swap ONE app (partial reconfiguration) while the others stay
     loaded;
  5. reconfigure the SHELL (drop the sniffer) without stranding any app;
  6. print the capture + fairness + status reports;
  7. weighted QoS: a gold tenant (weight 3) and a bronze tenant (weight 1)
     saturate the link through the shell scheduler — the contended byte
     split lands at ~3:1 and per-tenant Jain's indices come out of
     Shell.status().

    PYTHONPATH=src python examples_torch/multitenant_shell.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import (make_aes_artifact, make_hll_artifact,
                              make_passthrough_artifact,
                              make_vector_add_artifact)
from repro_torch.core import Alloc, Oper, SgEntry, Shell, ShellConfig
from repro_torch.core.credits import jains_index, weighted_jains_index
from repro_torch.core.services import AESConfig, MMUConfig, SnifferConfig
from repro_torch.core.services.sniffer import CSR_SNIFFER_ENABLE
from repro_torch.device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kib", type=int, default=64,
                    help="KiB a cThread moves per transfer")
    ap.add_argument("--qos-transfers", type=int, default=24,
                    help="transfers each QoS tenant queues")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    nbytes = args.kib << 10

    # 1. build
    shell = Shell(ShellConfig.make(services={
        "mmu": MMUConfig(page_size=256, n_pages=512),
        "encryption": AESConfig(),
        "sniffer": SnifferConfig(headers_only=False),
    }, n_vfpgas=3), device=device)
    report = shell.build()
    print(f"shell built in {report.total_s:.2f}s:",
          sorted(report.components))

    # 2. three tenants
    shell.load_app(0, make_aes_artifact("ecb"))
    shell.load_app(1, make_hll_artifact())
    shell.load_app(2, make_vector_add_artifact())
    sniffer = shell.services.get("sniffer")
    sniffer.csr.set_csr(1, CSR_SNIFFER_ENABLE)   # start capture via CSR

    # 3. concurrent traffic
    threads = [shell.attach_thread(i, pid=100 + i) for i in range(3)]
    for ct in threads:
        src = ct.getMem((Alloc.HPF, nbytes))
        src[:] = np.random.RandomState(ct.tid).randint(0, 255, src.size,
                                                       dtype=np.uint8)
        ct.invoke(Oper.LOCAL_TRANSFER,
                  SgEntry(src=ct.vaddr_of(src), length=src.size),
                  wait=False)
    shell.drain()
    shares = shell.arbiter.fairness()
    print(f"fair shares: { {k: round(v, 3) for k, v in shares.items()} } "
          f"jain={jains_index(shares):.4f}")

    # 4. app hot-swap: replace the vector-add tenant, others untouched
    stats = shell.reconfigure_app(2, make_passthrough_artifact())
    print(f"app hot-swap: {stats['kernel_s']*1e3:.1f} ms "
          f"(cache_hit={bool(stats['compile_cache_hit'])}); "
          f"slot0 still: {shell.vfpgas[0].app.name}")

    # 5. shell reconfig: drop the sniffer (scenario #3 of Table 3)
    lat = shell.reconfigure_shell(ShellConfig.make(services={
        "mmu": MMUConfig(page_size=256, n_pages=512),
        "encryption": AESConfig(),
    }, n_vfpgas=3))
    print(f"shell reconfig (sniffer off): kernel {lat['kernel_s']*1e3:.1f}"
          f" ms; services now: {shell.services.names()}")

    # 6. reports
    records = sniffer.to_records()
    print(f"sniffer captured {len(records)} packets; first 3:")
    for r in records[:3]:
        print("  ", r)
    print("final status:", {k: v for k, v in shell.status().items()
                            if k in ("fairness", "link_bytes")})
    shell.close()

    # 7. weighted QoS: gold tenant gets a 3x bandwidth share over bronze
    qos = Shell(ShellConfig.make(services={}, n_vfpgas=2), device=device)
    qos.build()
    qos.register_tenant("gold", 3.0, slots=(0,))
    qos.register_tenant("bronze", 1.0, slots=(1,))
    events = []
    qos.static.pcie.on_event(
        lambda ev: events.append((ev.t, ev.src.split("/", 1)[0],
                                  ev.nbytes)))
    gold, bronze = qos.attach_thread(0, pid=200), qos.attach_thread(1,
                                                                    pid=201)
    qos.scheduler.pause()              # queue demand first -> saturation
    for ct in (gold, bronze):
        for _ in range(args.qos_transfers):
            buf = ct.getMem((Alloc.REG, nbytes))
            ct.invoke(Oper.LOCAL_TRANSFER,
                      SgEntry(src=ct.vaddr_of(buf), length=buf.size),
                      wait=False)
    qos.scheduler.resume()
    qos.drain()
    finish = {}
    for t, ten, _ in events:
        finish[ten] = t
    t_star = min(finish.values())
    moved = {"gold": 0, "bronze": 0}
    for t, ten, nb in events:
        if t <= t_star:
            moved[ten] += nb
    sched = qos.status()["scheduler"]
    ctot = sum(moved.values())
    contended_jain = weighted_jains_index(
        {k: v / ctot for k, v in moved.items()},
        {"gold": 3.0, "bronze": 1.0})
    print(f"weighted QoS (3:1): contended split "
          f"{moved['gold'] / max(moved['bronze'], 1):.2f}:1, "
          f"contended jain_weighted={contended_jain:.4f} "
          f"(drained-total jain_weighted={sched['jain_weighted']:.4f})")
    for name, t in sorted(sched["tenants"].items()):
        print(f"  {name}: share={t['share']:.3f} weight={t['weight']:g} "
              f"mean_latency={t['mean_latency_s'] * 1e3:.2f}ms "
              f"batches={t['batches']}")
    qos.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
