"""Scenario: copy-on-write prefix sharing across templated requests.

The port of ``examples/prefix_sharing.py`` (decode on the CUDA card).
Chatbots and agent fleets send many prompts that start with the same
system preamble.  The MMU content-keys full prompt pages (a chain hash
over token blocks), so ``alloc_seq`` maps the covered prefix onto
EXISTING physical pages with a refcount bump; the engine then prefills
only the uncovered suffix and admission charges page credits only for
private pages.  Writes to a shared page copy-on-write-fault onto a
fresh private page, so sharing is invisible to tenants — the demo ends
with a token-for-token parity check against a sharing-disabled engine.

    PYTHONPATH=src python examples_torch/prefix_sharing.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServingEngine

PAGE = 16
SYSTEM_PROMPT = list(range(3, 3 + 4 * PAGE))      # 4-page shared preamble


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=6,
                    help="templated requests in the parity run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device=device)

    def serve(sharing: bool, n_pages: int = 96):
        mmu = MMU(MMUConfig(page_size=PAGE, n_pages=n_pages,
                            prefix_sharing=sharing))
        eng = ServingEngine(cfg, params, mmu, max_batch=4, max_len=256,
                            seed=5, device=device)
        for uid in range(args.users):
            eng.submit(SYSTEM_PROMPT + [100 + uid, 200 + uid],
                       max_new_tokens=8,
                       temperature=0.0 if uid % 2 else 0.6)
        eng.run()
        return eng, {tuple(r.prompt): list(r.out_tokens)
                     for r in eng.completed}

    # --- 1. templated traffic: shared prefill work is skipped ------------
    eng, outs = serve(sharing=True)
    util = eng.mmu.utilization()
    print(f"prefix hits: {util['prefix_hits']}, "
          f"prefill computed/skipped: {eng.prefill_computed}"
          f"/{eng.prefill_skipped}")
    assert util["prefix_hits"] > 0, "templated prompts must hit the index"
    assert eng.prefill_skipped > 0, "covered pages must skip prefill compute"

    # --- 2. sharing is invisible: token-for-token parity -----------------
    _, outs_private = serve(sharing=False)
    assert outs == outs_private, "sharing must not change any output token"
    print(f"parity: {len(outs)} completions identical with sharing on/off")

    # --- 3. admission: shared pages cost no page credits -----------------
    def admitted(sharing: bool) -> int:
        mmu = MMU(MMUConfig(page_size=PAGE, n_pages=12,
                            prefix_sharing=sharing))
        eng = ServingEngine(cfg, params, mmu, max_batch=8, max_len=256,
                            device=device)
        for uid in range(8):
            eng.submit(SYSTEM_PROMPT + [100 + uid], max_new_tokens=8)
        eng.step()                                # one admission pass
        return eng.active

    base, shared = admitted(False), admitted(True)
    print(f"concurrent sequences in a 12-page pool: "
          f"{base} private vs {shared} shared")
    assert shared >= 2 * base, "sharing must at least double admissions"

    # --- 4. copy-on-write: a write to a shared page stays private --------
    mmu = MMU(MMUConfig(page_size=PAGE, n_pages=16))
    mmu.alloc_seq(1, len(SYSTEM_PROMPT), prompt_tokens=SYSTEM_PROMPT)
    mmu.alloc_seq(2, len(SYSTEM_PROMPT), prompt_tokens=SYSTEM_PROMPT)
    before = mmu.translate(2, 0)[0]
    after = mmu.translate(2, 0, for_write=True)[0]    # CoW fault
    assert after != before and mmu.translate(1, 0)[0] == before
    assert mmu.utilization()["cow_faults"] == 1
    print(f"CoW: writer remapped {before} -> {after}, sharer untouched")

    print("OK: prefix sharing pays (skipped prefill, 2x admissions) and "
          "stays invisible (parity, CoW isolation)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
