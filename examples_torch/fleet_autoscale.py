"""Fleet controller: placement, health sweeps, pre-copy auto-migration.

The port of ``examples/fleet_autoscale.py``, on PyTorch shells (their
device the CUDA card).  Three shells form a fleet under a
``FleetController``.  The demo walks the control plane's three verbs end
to end:

1. **Placement** — ``place()`` scores members by free-page fraction
   minus a recent-fault penalty and picks the landing member for a new
   tenant (a member that cannot fit is excluded outright).
2. **Auto-migration** — tenant "gold" decodes on a deliberately small
   member; ``sweep()`` (the reconcile loop body, NOT a manual migrate
   call) flags the hotspot and pre-copy-migrates the tenant to the
   coldest member while it keeps serving: warm rounds ship KV pages,
   the freeze carries only the dirty delta.
3. **Stream re-homing** — both members run ``ServingGateway``s; the
   move re-routes the live ``TokenStream``s, so readers keep their
   stream objects and every stream finishes exactly once.

An undisturbed oracle engine proves token-for-token continuity; the
script exits non-zero on any lost/duplicated stream or divergence.

Run: PYTHONPATH=src python examples_torch/fleet_autoscale.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import Shell, ShellConfig
from repro_torch.core.services import MMUConfig
from repro_torch.device import resolve_device
from repro_torch.fleet import FleetController
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.gateway import ServingGateway

PAGE = 16


def mk_shell(name: str, pool: int, device) -> Shell:
    s = Shell(ShellConfig.make(
        services={"mmu": MMUConfig(page_size=PAGE, n_pages=pool)},
        n_vfpgas=2), name=name, device=device)
    s.build()
    return s


def mk_engine(cfg, params, shell, *, rid_base=0) -> ServingEngine:
    return ServingEngine(cfg, params, shell.services.get("mmu"),
                         max_batch=4, max_len=256, shell=shell, slot=0,
                         tenant="gold", rid_base=rid_base,
                         device=shell.device)


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

    small = mk_shell("edge-small", 32, device)  # 32 x 16 = 512 tokens
    big = mk_shell("pod-big", 256, device)
    oracle_shell = mk_shell("oracle", 256, device)
    eng_small = mk_engine(cfg, params, small, rid_base=0)
    eng_big = mk_engine(cfg, params, big, rid_base=1000)
    oracle = mk_engine(cfg, params, oracle_shell, rid_base=2000)
    gw_small = ServingGateway(eng_small, admission="fifo")
    gw_big = ServingGateway(eng_big, admission="fifo")

    # the ramp prompts share prefixes, so CoW dedup keeps the small
    # member near 9 unique pages (util ~0.28) — threshold just under
    fc = FleetController(precopy=True, hot_util=0.25, cold_util=0.60)
    fc.add_shell(small)
    fc.add_shell(big)
    fc.attach_gateway(small, gw_small)
    fc.attach_gateway(big, gw_big)

    # ---- hotspot forms on the small member ---------------------------------
    prompts = [list(range(3, 3 + n)) for n in (60, 90, 40)]
    streams = [gw_small.submit(p, max_new_tokens=args.max_new)
               for p in prompts]
    oracle_rids = [oracle.submit(p, max_new_tokens=args.max_new)
                   for p in prompts]
    for _ in range(4):
        gw_small.step()
        oracle.step()
    load = fc.member_load(small)
    print(f"member {load['name']!r}: {load['pages_used']}/"
          f"{load['pages_total']} pages (util {load['util']:.2f}) -> hot")

    # ---- placement ---------------------------------------------------------
    pick = fc.place(pages_needed=8)
    print(f"placement: a NEW 8-page tenant would land on {pick.name!r} "
          f"(free-fraction scoring avoids the hot member)")
    assert pick is big
    assert fc.place(pages_needed=10**6) is None     # nobody can fit it

    # ---- the controller decides (sweep, not a manual migrate) --------------
    moved = [d for d in fc.sweep() if d.action == "migrate" and d.ok]
    assert moved, "sweep did not auto-migrate the hotspot"
    rep = moved[0].report
    print(f"\nsweep auto-migrated {moved[0].tenant!r}: "
          f"{moved[0].src} -> {moved[0].dst} ({moved[0].reason})")
    print(f"  pre-copy   {rep.precopy_rounds} warm rounds, "
          f"{rep.precopy_pages} pages shipped while serving")
    print(f"  freeze     {rep.delta_pages} dirty-delta pages, "
          f"downtime {rep.downtime_s * 1e3:.2f} ms")

    # ---- streams were re-homed; finish them on the big member --------------
    gw_big.drain()
    while oracle.pending():
        oracle.step()
    assert all(s.done and s.error is None for s in streams)
    assert not gw_small.streams and not gw_small.queue
    done = sorted(id(s) for s in gw_big.completed)
    assert done == sorted(id(s) for s in streams), \
        "streams lost or duplicated across the auto-migration"
    oracle_out = {r.rid: r.out_tokens for r in oracle.completed}
    for s, orid in zip(streams, oracle_rids):
        assert s.tokens == oracle_out[orid], \
            f"token divergence on stream {s.rid}"
    print(f"\nre-homed {len(streams)} live streams to {moved[0].dst!r}: "
          "all finished exactly once, token-for-token equal to the "
          "undisturbed oracle")
    assert small.services.get("mmu").utilization()["pages_used"] == 0
    print(f"{small.name!r} pages fully released; controller log: "
          f"{fc.status()['moves']} move(s), "
          f"{len(fc.decisions)} decision(s)")

    for s in (small, big, oracle_shell):
        s.close()
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
